"""Tools run once when a cell is defined (not by the benchmark's runs)."""

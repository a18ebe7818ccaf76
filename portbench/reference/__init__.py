"""Plain reference implementations the benchmark checks the program
against. Nothing here imports the program under test."""

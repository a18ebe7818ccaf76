"""Simulation: types, evaluator tables, the flat engine, the fused kernel."""

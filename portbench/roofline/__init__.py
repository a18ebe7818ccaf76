"""Peaks of the card and the operations and bytes of the program's hand
kernels, counted from their shapes."""

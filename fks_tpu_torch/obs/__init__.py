"""Observability: the decision-trace tools and the recorder seam."""

"""Scheduling policies: the zoo baselines and the parametric basis."""

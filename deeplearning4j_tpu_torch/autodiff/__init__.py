"""Ops on tensors (the recurrent ops so far)."""

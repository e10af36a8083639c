"""Model restore and weight conversion."""

"""Host data containers and iterators."""

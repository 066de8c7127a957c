"""Tree-guided reference-anchored multiple sequence alignment."""

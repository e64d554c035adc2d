"""Heightmap ripping: subprocess contract + layer listing + test stub."""

"""Game-domain logic: ballistics, heightmaps, capture, firing solutions."""

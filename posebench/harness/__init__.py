"""The benchmark's machinery: the manifest, the card, seeded weights and
data, traces and the comparison that decides ``correct``."""

"""One reader a metric (metrics/<name>.py): `read(readings)` returns the
metric's value from a harness.Readings, or None where the run holds
nothing for it to read (never a 0 in its place)."""

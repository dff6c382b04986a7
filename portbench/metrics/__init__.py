"""One reader per per-layer metric, ``<metric>.py`` with ``read(run)``,
found by the metric's name; ``_roofline.py`` holds the byte counts."""

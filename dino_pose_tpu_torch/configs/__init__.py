"""The port's default configuration files (``configs/config.py``)."""

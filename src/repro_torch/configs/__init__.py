"""Model configurations of the port (see ``configs/capsim.py``)."""

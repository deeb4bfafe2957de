"""Layers of the PyTorch port (``models/layers.py``)."""

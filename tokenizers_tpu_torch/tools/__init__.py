"""Measurement scripts of the port, run on the card, and `EncodingVisualizer`
(`visualizer.py`)."""
from .visualizer import Annotation, EncodingVisualizer

__all__ = ["Annotation", "EncodingVisualizer"]

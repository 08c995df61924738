"""Multi-stream serving (`serving.py`)."""

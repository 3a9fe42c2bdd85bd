"""Data-parallel solves over processes (``mesh.py``)."""

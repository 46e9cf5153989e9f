"""Training, serving and evaluation over several devices (``mesh.py``)."""

"""The plain reference model that decides ``correct`` (``model.py``)."""

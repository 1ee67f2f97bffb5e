"""Request streams for the serving engine (``requests.py``, copied from ``repro.data``)."""

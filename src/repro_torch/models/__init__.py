"""Models of the port beyond the Table 2 BCNN (``core/bcnn.py``)."""

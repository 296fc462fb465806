"""API handlers of the port: queries (`vlselect.py`), inserts
(`vlinsert.py`) and the request helpers they share (`insertutil.py`)."""

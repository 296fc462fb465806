"""Query API handlers of the port (`vlselect.py`) and the request
helpers they share (`insertutil.py`)."""

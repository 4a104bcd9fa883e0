"""Layer classes of the port (``paddle.nn`` counterparts)."""

"""Fleet utilities of the port (``paddle.distributed.fleet``)."""

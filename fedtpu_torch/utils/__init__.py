"""Host utilities of the port (``fedtpu.utils``): timing."""

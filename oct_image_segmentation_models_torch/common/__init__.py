"""Host-side helpers of the port: checkpoint I/O and the weights bridge."""

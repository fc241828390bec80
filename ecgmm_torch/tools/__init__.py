"""Tools: weight conversion between the JAX reference and the port, record
directory writers, and the timing and precision scripts run on the card."""

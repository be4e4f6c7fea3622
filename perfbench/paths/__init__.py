"""Entry paths: one module per way of driving the program (``Entry``)."""

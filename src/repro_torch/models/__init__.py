"""Model layers of the port; so far the attention oracle (``attention``)."""

"""LM framework: layers, the dense transformer and Mamba-2 families, and
the family dispatcher (``model``)."""

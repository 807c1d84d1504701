"""Model code of the port: the dense LM's init and its operator-graph
exporter (the parts of the JAX package's ``models/`` that the main path
runs)."""

"""Core of the port: COO tensors, layouts, plans, MTTKRP front door, CPD-ALS."""

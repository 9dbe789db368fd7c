"""Dense decoder model of the port."""

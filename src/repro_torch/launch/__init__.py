"""Entry points of the port: the coherent serving launcher."""

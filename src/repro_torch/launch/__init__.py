"""Entry points of the port: the coherent serving launcher, the
coherence-service launcher and the authority shards' streams."""

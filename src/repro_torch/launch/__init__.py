"""Entry points of the port: the coherent serving launcher, the
coherence-service launcher and the authority shards' streams, and the
cost model (``analytic``: FLOPs and HBM bytes of a cell; ``roofline``:
the card's rates and the one-card roofline report)."""

"""Language models of the port: the decoder-only attention + MoE family
(``zoo.build``), in the JAX package's parameter layout."""

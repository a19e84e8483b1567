"""Language models of the port: the decoder-only families -- dense, MoE,
MLA, Mamba-2 (SSM), the Jamba hybrid and the VLM backbone -- and the
encoder-decoder whisper (``zoo.build``), in the JAX package's parameter
layout."""

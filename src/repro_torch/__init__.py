"""PyTorch/CUDA port of the PGM-ASR system (the RNN-T training and
selection path), beside the JAX reference package ``repro``."""

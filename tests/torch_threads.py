"""One intra-op thread for PyTorch in the port's CPU tests.

The tests run under pytest-xdist, several worker processes on one host.
Each PyTorch process would otherwise start an OpenMP pool as wide as the
host, and the pools of the workers spin against each other: on an
8-core host, six processes running the same two RG-LRU tests at once
took 82 s with the default pools and 50 s with one thread each.  The
tests' shapes are small, so one thread loses little when a file runs
alone.

Every ``tests/test_torch_*.py`` imports this module, so that a file run
on its own gets the same setting as in the whole run.  It sets PyTorch's
intra-op threads of this process only; JAX's thread pool and the
environment of child processes are left as they are."""
import torch

torch.set_num_threads(1)

"""Random-number discipline: explicit generators only.

``global-rng`` (the reference's ``key-reuse``, whose invariant is that
each draw comes from a stream the caller controls): PyTorch's
counterpart of a JAX key is a ``torch.Generator``.  A sampler called
without ``generator=`` draws from the process-global stream, which any
other draw (a library's, another thread's, a test's) advances, so a run
is no longer a function of its seed; ``torch.manual_seed`` /
``torch.cuda.manual_seed`` reseed that global stream for everyone.  So
every ``torch.rand*``, ``randn``, ``randint``, ``randperm``, ``normal``,
``bernoulli``, ``multinomial`` (and the ``*_like`` samplers) and every
in-place ``Tensor`` sampler (``normal_``, ``uniform_``, ``bernoulli_``,
``random_``, ``exponential_``, ``geometric_``, ``log_normal_``,
``cauchy_``) passes ``generator=``, and the package never seeds the
global stream.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.astutil import call_name
from repro_torch.analysis.lint import Finding, SourceFile, register

SAMPLERS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
            "multinomial", "poisson", "rand_like", "randn_like",
            "randint_like"}
INPLACE_SAMPLERS = {"normal_", "uniform_", "bernoulli_", "random_",
                    "exponential_", "geometric_", "log_normal_", "cauchy_"}
GLOBAL_SEEDS = {"torch.manual_seed", "torch.cuda.manual_seed",
                "torch.cuda.manual_seed_all", "torch.seed",
                "torch.random.manual_seed"}
# the *_like samplers take no generator: they always draw globally
_NO_GENERATOR = {"rand_like", "randn_like", "randint_like"}


@register("global-rng",
          "every torch sampler passes generator= and nothing seeds the "
          "global stream (torch.manual_seed): explicit generators only")
def check_global_rng(sf: SourceFile) -> List[Finding]:
    out = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node) or ""
        kws = {kw.arg for kw in node.keywords}
        if name in GLOBAL_SEEDS:
            out.append(Finding(
                "global-rng", sf.path, node.lineno,
                f"`{name}(...)` reseeds the process-global stream: seed a "
                f"torch.Generator and pass it"))
            continue
        short = name.rsplit(".", 1)[-1]
        if name.startswith("torch.") and short in SAMPLERS and \
                name.count(".") == 1:
            if short in _NO_GENERATOR:
                out.append(Finding(
                    "global-rng", sf.path, node.lineno,
                    f"`{name}` takes no generator and draws from the "
                    f"global stream: use the sampler with generator="))
            elif "generator" not in kws:
                out.append(Finding(
                    "global-rng", sf.path, node.lineno,
                    f"`{name}(...)` without generator= draws from the "
                    f"process-global stream"))
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in INPLACE_SAMPLERS and \
                "generator" not in kws:
            out.append(Finding(
                "global-rng", sf.path, node.lineno,
                f"`.{node.func.attr}(...)` without generator= draws from "
                f"the process-global stream"))
    return out

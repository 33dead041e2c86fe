"""Serving A/B of two checkouts of the PyTorch port on one card.

    python3 scripts/serve_ab.py OLD_TREE NEW_TREE

OLD_TREE and NEW_TREE are the roots of two checkouts, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.``.  Each tree runs in a process of its own, in the order old,
new, new, old, so that a drift of the card or its host shows as a
difference between the two runs of one tree.  A run builds the tree's
kernels, serves the same random ``starcoder2-3b`` (full width and depth,
weights from seed 0) once on short prompts to warm up, then twice:
``generate`` on 2 prompts of 8,192 tokens with 32 new tokens, and
``SlotEngine`` (4 slots, sync every 4) on the serve launcher's 8 requests
of ``--prompt-len 8192`` with 32 new tokens.  It prints the prefill time,
the decode time a step, the band kernel's launches and the slot engine's
wall time, after the card's name and power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

PROMPT = 8192
NEW = 32
REQUESTS = 8
SLOTS = 4


def child(tree: str, tag: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.backend import fp32_numerics, resolve_device
    from repro_torch.kernels.swa_attn.ops import swa_attn_op
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import SlotEngine, generate

    dev = resolve_device("cuda")
    fp32_numerics()
    cfg = get_config("starcoder2-3b")
    bundle = build_model(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0), dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, PROMPT), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1)).to(dev)
    reqs = make_requests(cfg, REQUESTS, PROMPT, NEW, seed=0)
    # warm up the band, flash and decode paths (and build the kernels)
    generate(bundle, params, prompts[:, :cfg.window + 1104], 2)
    torch.cuda.synchronize()
    for _ in range(2):
        swa_attn_op.launches = 0
        _, st = generate(bundle, params, prompts, NEW)
        print(f"{tag} generate 2 x {PROMPT} + {NEW}: prefill "
              f"{st.prefill_s * 1e3:.1f} ms, decode "
              f"{st.decode_s * 1e3 / st.decode_steps:.1f} ms a step, "
              f"swa_attn launches {swa_attn_op.launches}", flush=True)
        eng = SlotEngine(bundle, params, n_slots=SLOTS, max_new_tokens=NEW,
                         max_prompt_len=PROMPT, sync_every=4, seed=0)
        torch.cuda.synchronize()
        t0 = time.time()
        comps = eng.run(reqs)
        wall = time.time() - t0
        lat = sorted(c.latency_s for c in comps)
        print(f"{tag} SlotEngine {REQUESTS} requests / {SLOTS} slots: "
              f"{wall:.3f} s wall, p50 latency "
              f"{lat[len(lat) // 2] * 1e3:.0f} ms", flush=True)


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
        return
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    old, new = sys.argv[1:]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree, tag in ((old, "old"), (new, "new"), (new, "new"), (old, "old")):
        subprocess.run([sys.executable, __file__, "--child", tree, tag],
                       check=True)


if __name__ == "__main__":
    main()

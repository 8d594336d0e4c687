#!/usr/bin/env python3
"""Where a sampler block draws its Brownian increments, on the card.

    python3 scripts/sampler_draws.py [blocks]

The port's samplers (``colvarsfinder_tpu_torch/utils/sampling.py``) run
each report block as one captured CUDA graph. Its ``[n_sub, c, d]``
increments can be drawn (a) before each replay, outside the graph, into the
fixed buffer the graph reads (what the samplers do), or (b) inside the
graph, from a ``torch.Generator`` registered with it
(``CUDAGraph.register_generator_state``), each replay advancing the
generator's offset. This script integrates chip_smoke phase 12 (a)'s
configuration (TripleWellCircle at beta 8, 1,024 chains, blocks of 100
Euler–Maruyama steps of 0.001) both ways from the same generator seed, in
turns (a, b, b, a), and prints the wall time per block of each turn, the
chain-steps/s, and whether the two ways give the same bits.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from colvarsfinder_tpu_torch.utils import sampling as S  # noqa: E402

CHAINS, N_SUB, DT, BETA = 1024, 100, 1e-3, 8.0


class TripleWellCircle:
    dim, beta = 2, BETA

    def V(self, x):
        theta = torch.atan2(x[1], x[0])
        r = torch.sqrt(x[0] ** 2 + x[1] ** 2)
        return 1.0 + torch.cos(3.0 * theta) + 8.0 * (r - 1.0) ** 2


def run(inside: bool, blocks: int):
    """``blocks`` blocks after the eager first one and the capture; returns
    (seconds per replayed block, final chains)."""
    grad = S._grad_fn(TripleWellCircle())
    x = torch.tensor([[0.5, -0.866]], device="cuda").repeat(CHAINS, 1)
    buf = torch.empty((N_SUB, CHAINS, 2), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dt, scale = S._f32(DT), float(S._noise_scale(DT, BETA))

    def body():
        if inside:
            buf.normal_(generator=gen)
        for j in range(N_SUB):
            x.copy_(x - grad(x) * dt + scale * buf[j])

    if not inside:
        buf.normal_(generator=gen)
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        body()
    graph = torch.cuda.CUDAGraph()
    if inside:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=side):
        body()
    current.wait_stream(side)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(blocks):
        if not inside:
            buf.normal_(generator=gen)
        graph.replay()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / blocks, x.cpu().numpy()


def main():
    if not torch.cuda.is_available():
        sys.exit("sampler_draws.py needs an NVIDIA card")
    blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows, finals = [], {}
    for inside in (False, True, True, False):
        per_block, final = run(inside, blocks)
        label = "inside the graph" if inside else "before each replay"
        finals[label] = final
        rows.append({"draws": label, "ms_per_block": per_block * 1e3,
                     "chain_steps_per_s": CHAINS * N_SUB / per_block})
        print(f"draws {label:18s}: {per_block * 1e3:.4f} ms per block of "
              f"{N_SUB} steps, {rows[-1]['chain_steps_per_s']:,.0f} "
              f"chain-steps/s", flush=True)
    same = np.array_equal(*finals.values())
    print(f"the two ways give the same chains bit for bit: {same}")
    print(json.dumps({"card": card, "blocks": blocks, "turns": rows,
                      "same_bits": bool(same)}))


if __name__ == "__main__":
    main()

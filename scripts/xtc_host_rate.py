#!/usr/bin/env python3
"""Host rate of the port's XTC codec, on whatever machine runs it.

    python3 scripts/xtc_host_rate.py [frames]

Writes ``frames`` (default 100,000) frames of 22 atoms, made from seed 0
as chip_smoke phase 13 makes them (noise of 0.3 nm around a reference),
with ``write_xtc`` (the native encoder built from ``native/fastio.cpp``),
reads them back with ``read_xtc`` (the native decoder), and decodes the
first 2,000 frames with the pure-Python codec. Prints the seconds, frames/s,
MB/s and bytes per frame of each, the host's name and whether the native
library was used. No card is needed: everything here runs on the host.
"""

from __future__ import annotations

import os
import platform
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from colvarsfinder_tpu_torch.utils import native_io, xtc  # noqa: E402

N_ATOMS, PY_FRAMES = 22, 2_000


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((N_ATOMS, 3)).astype(np.float32)
    frames = ref[None] + 0.3 * rng.standard_normal((n, N_ATOMS, 3),
                                                   dtype=np.float32)
    print(f"host {platform.node()} ({platform.processor() or 'cpu'}), "
          f"native library: {native_io.available()}")
    with tempfile.TemporaryDirectory() as tmp:
        path, head = os.path.join(tmp, "a.xtc"), os.path.join(tmp, "h.xtc")
        t0 = time.perf_counter()
        xtc.write_xtc(path, frames, dt_ps=1.0)
        write_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        coords, _dt, _times = xtc.read_xtc(path)
        read_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            buf = f.read()
        off = 0
        for _ in range(min(PY_FRAMES, n)):
            off, _natoms, _t = xtc._skip_frame(buf, off)
        with open(head, "wb") as f:
            f.write(buf[:off])
        real = native_io.decode_xtc
        native_io.decode_xtc = lambda *a, **k: None
        try:
            t0 = time.perf_counter()
            py, _dt, _times = xtc.read_xtc(head)
            py_s = time.perf_counter() - t0
        finally:
            native_io.decode_xtc = real
    print(f"write_xtc: {n:,} frames, {mb:.2f} MB ({1e6 * mb / n:.0f} bytes "
          f"a frame) in {write_s:.3f} s")
    print(f"read_xtc: {read_s:.3f} s, {n / read_s:,.0f} frames/s, "
          f"{mb / read_s:.1f} MB/s; max |error| "
          f"{float(np.abs(coords - frames).max()):.3e} nm")
    print(f"Python decoder: {len(py):,} frames in {py_s:.3f} s, bit for bit "
          f"the native decode: {np.array_equal(py, coords[:len(py)])}")


if __name__ == "__main__":
    main()

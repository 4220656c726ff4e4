"""The walk graph's device layout of one checkout of the port, on the card.

Generates the large-graph path's R-MAT graph (env N, DRAWS; default
SCALE_r05.md's 10,000,000 nodes and 120,000,000 draws) with this tree's
`graph/synthetic.py:rmat_pairs_chunked`, builds it with the measured
checkout's `csr_from_edges`, then times the checkout's upload
(`device_graph`), first-hop shuffle (`shuffled_indices_for`, seed 0) and
edge tables (`walk_tables_for`), each with the device's live bytes and
its peak, and prints the cached tensors' dtypes and bytes a directed
edge. Run from the repository root, naming the directory that holds the
`surel_plus_tpu_torch` to measure:

    python results/torch_h100/scale_layout_probe.py .          # this tree
    python results/torch_h100/scale_layout_probe.py _checkout/parent

(`_checkout/parent`: a parent commit unpacked with `git archive`.)
"""

import importlib.util
import os
import subprocess
import sys
import time

PKG_ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, PKG_ROOT)
TREE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch  # noqa: E402

from surel_plus_tpu_torch.graph.csr import csr_from_edges  # noqa: E402
from surel_plus_tpu_torch.ops import sampler  # noqa: E402


def tree_synthetic():
    """This tree's graph/synthetic.py (its imports resolve to the measured
    checkout's package, which has what it needs)."""
    spec = importlib.util.spec_from_file_location(
        "tree_synthetic",
        os.path.join(TREE, "surel_plus_tpu_torch", "graph", "synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    n = int(os.environ.get("N", 10_000_000))
    draws = int(os.environ.get("DRAWS", 120_000_000))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; package "
          f"{os.path.relpath(sampler.__file__, TREE)}", flush=True)
    t0 = time.perf_counter()
    edges = tree_synthetic().rmat_pairs_chunked(n, draws, 0)
    g = csr_from_edges(edges, num_nodes=n, symmetrize=True)
    del edges
    print(f"graph: N={n:,} nnz={g.num_edges:,} ({time.perf_counter() - t0:.1f}"
          f" s on the host)", flush=True)
    dev = torch.device("cuda")
    for name, fn in (("upload", lambda: sampler.device_graph(g, dev)),
                     ("shuffle", lambda: sampler.shuffled_indices_for(
                         g, 0, dev)),
                     ("tables", lambda: sampler.walk_tables_for(g, 0, dev))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"{name}: {time.perf_counter() - t0:.3f} s, device live "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    total = indptr = 0
    for key, val in g._device_cache.items():
        tensors = val if isinstance(val, tuple) else (val,)
        size = sum(t.numel() * t.element_size() for t in tensors)
        total += size
        if key[0] == "csr":
            indptr = tensors[0].numel() * tensors[0].element_size()
        shapes = [(tuple(t.shape), str(t.dtype)) for t in tensors]
        print(f"  {key[0]}: {shapes} {size:,} B", flush=True)
    print(f"walk graph on the device: {total:,} B = "
          f"{(total - indptr) / g.num_edges:.2f} B a directed edge x "
          f"{g.num_edges:,} + indptr {indptr:,} B", flush=True)


if __name__ == "__main__":
    main()

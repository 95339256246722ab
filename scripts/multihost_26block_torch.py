#!/usr/bin/env python3
"""Two processes over all 26 blocks: the port's counterpart of
`scripts/multihost_26block.py`, on the card or on the CPU.

Each configuration runs `sharp_tpu_torch.sharp_unlimited(multihost=True)` in
two processes, 13 blocks each. The processes join a torch.distributed group
over gloo on a free localhost port through torchrun's variables, with
LOCAL_WORLD_SIZE=2 so that two processes on one card divide its memory.

  (a) mechanics: 26 SBLK blocks of 2,000 cells x 400 genes (10 planted
      types, tests/synth.py seed 26), n_cells declared 1,306,127 so that
      smetac_range's >= 1e6 widening is live (and with it the widened
      all-gather budget). The two processes agree on the cluster count; 26
      manifests are written, all with one configuration fingerprint; a
      second two-process run resumes every block from them, runs no fold
      pass (on the card: launches nothing outside the global fuse) and
      gives the cold run's labels; one process gives the two processes'
      labels, concatenated.
  (b) quality: 26 x 2,000 cells, 8 planted types at 600 genes, K=8, p=128,
      folds of 1,000, n_cells as the blocks hold: ARI >= 0.9 against the
      planted types; one process gives the two processes' labels. On the
      card the script also runs (b) in one process with the RP matrix the
      CPU draws, injected, and in one process on the CPU: identical labels
      (the CUDA generators' streams are not the CPU's for one seed, so
      the card's own draws give other clusters).
  (c) flagship, card only: the bench API path's 26 SBLK blocks (25 x 50,000
      + 56,127 cells x 27,998 genes, 38 planted types, 2,048 nonzeros a
      cell), made on demand into `io.benchdata`'s cache (about 21 GB under
      ~/.cache/sharp_tpu_torch/benchdata or SHARP_BENCH_API_DIR) and kept
      there, with the bench's knobs (K=5, p=256, bf16 RP product, forview
      off): the checks of (a), the bench's full-scale gates (ARI >= 0.80, at
      most 57 clusters), and each process's cold run launched every kernel.

The one-process reference runs in this process with resume off and a
manifest directory of its own (with the pair's, it would resume from the
pair's manifests). Any failed check raises.

Usage:
    python scripts/multihost_26block_torch.py                   # (a), (b), (c) on the card
    python scripts/multihost_26block_torch.py --device cpu      # (a), (b) on the CPU
    python scripts/multihost_26block_torch.py --config flagship # one configuration (repeatable)
    python scripts/multihost_26block_torch.py --quality-only    # = --config quality, as the JAX script

Each configuration prints its record as one JSON line and writes it to
chiprun_out/multihost_26block_torch_<config>.json (gitignored). With
--device cuda and no card the script exits 1 and prints no result. It
imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX script's configurations (scripts/multihost_26block.py:41-66)
N_BLOCKS = 26
BLOCK_CELLS = 2000
N_GENES = 400
DECLARED_CELLS = 1_306_127  # mechanics config only
KW = dict(rN_seed=3, ensize_K=3, reduced_ndim=48, base_ncells=200, partition_ncells=250)
QUAL_TYPES = 8
QUAL_GENES = 600
KW_Q = dict(rN_seed=3, ensize_K=8, reduced_ndim=128, base_ncells=200, partition_ncells=1000)
QUAL_MIN_ARI = 0.9
# the bench's API path at full scale (bench_torch.py: _bench_env, api_bench,
# api_gates): 25 x 50,000 + 56,127 cells (reference README.md:287-303)
FLAGSHIP_BLOCKS = [50_000] * 25 + [56_127]
FLAGSHIP_GENES, FLAGSHIP_TYPES, FLAGSHIP_NNZ = 27_998, 38, 2048
KW_F = dict(rN_seed=7, ensize_K=5, reduced_ndim=256, partition_ncells=2000,
            dtype_compute="bfloat16", forview=False)
FLAGSHIP_MIN_ARI = 0.80

KERNELS = ("rnn_round", "rnn_pairs", "rnn_tail", "ward_serial", "cutree")
LINKAGE_KERNELS = ("rnn_tail", "ward_serial")
CONFIGS = ("mechanics", "quality", "flagship")
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _paths():
    for p in (REPO, os.path.join(REPO, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)


def make_dataset(d, n_types=10, n_genes=N_GENES, n_blocks=N_BLOCKS, block_cells=BLOCK_CELLS):
    """Write n_blocks SBLK blocks of block_cells cells (tests/synth.py's
    make_tpm_like, seed 26) into d; returns the planted types."""
    _paths()
    from synth import make_tpm_like

    from sharp_tpu_torch.io.blocks import save_blocks

    X, y = make_tpm_like(n_cells=n_blocks * block_cells, n_genes=n_genes, n_types=n_types, seed=26)
    save_blocks(d, [X[i * block_cells:(i + 1) * block_cells] for i in range(n_blocks)], fmt="sblk")
    return y


def _die_with_parent():
    """Have the kernel kill this process when its parent dies, so that a
    worker never outlives the run that started it (Linux; elsewhere the
    pair's timeout kills it)."""
    import ctypes
    import signal

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    except (AttributeError, OSError):
        pass


def patched_rp(streaming, R):
    """Inject the numpy matrix R (genes, K*p) as the streaming module's RP
    matrix; returns the function to restore."""
    import torch

    real = streaming.ensemble_rp_matrix

    def fixed(seed, K, m, p, dtype=torch.float32, device="cpu"):
        if R.shape != (m, K * p):
            raise ValueError(f"injected RP matrix {R.shape} for ({m}, {K * p})")
        return torch.from_numpy(R).to(device, dtype)

    streaming.ensemble_rp_matrix = fixed
    return real


def worker(spec):
    """One process of a pair: joins the group through torchrun's variables,
    runs sharp_unlimited(multihost=True) and writes its labels, cluster
    count, seconds, stages, launches (all, and those of the global fuse) and
    the blocks it ran the fold pass on to spec["out"]."""
    _die_with_parent()
    import torch

    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    _paths()
    from sharp_tpu_torch import sharp_unlimited
    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.parallel import streaming

    if spec["rp"]:
        patched_rp(streaming, np.load(spec["rp"]))
    blocks_run, fuse_launches = [], {}
    real_pass, real_fuse = streaming._fold_pass, streaming.global_block_fuse

    def counted_pass(*a, **k):
        blocks_run.append(1)
        return real_pass(*a, **k)

    def counted_fuse(*a, **k):
        before = dict(linkage_cuda.LAUNCHES)
        try:
            return real_fuse(*a, **k)
        finally:
            fuse_launches.update({n: linkage_cuda.LAUNCHES[n] - before[n] for n in before})

    streaming._fold_pass, streaming.global_block_fuse = counted_pass, counted_fuse
    t0 = time.perf_counter()
    r = sharp_unlimited(spec["ddir"], multihost=True, manifest_dir=spec["mdir"], device=spec["device"],
                        **spec["kw"])
    seconds = time.perf_counter() - t0
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sharp_tpu")]
    if loaded:
        raise AssertionError(f"the port loaded {loaded[:5]}")
    info = dict(n=int(r.N_pred_cluster), seconds=seconds, blocks_run=len(blocks_run),
                launches=dict(linkage_cuda.LAUNCHES), fuse_launches=fuse_launches,
                stages={s["stage"]: s["seconds"] for s in r.timing["stages"]})
    np.savez(spec["out"], labels=r.pred_clusters, info=json.dumps(info))


def _tail(path, n=3000):
    with open(path, errors="replace") as fh:
        return fh.read()[-n:]


def start_pair(ddir, mdir, kw, work, tag, device, *, rp=None, threads=None, timeout=1800):
    """Start the two processes of one run over the block directory ddir
    (manifests into mdir); `finish_pair` waits for them. threads: torch
    threads a process (default half the cores); rp: a .npy RP matrix both
    use in place of their own draws."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    threads = threads or max(1, (os.cpu_count() or 2) // 2)
    pair = dict(procs=[], outs=[], logs=[], tag=tag, deadline=time.monotonic() + timeout,
                t0=time.perf_counter())
    try:
        for rank in range(2):
            out, log = (os.path.join(work, f"{tag}_p{rank}.{ext}") for ext in ("npz", "log"))
            spec = dict(ddir=ddir, mdir=mdir, kw=kw, device=device, rp=rp, threads=threads, out=out)
            with open(log, "w") as fh:
                pair["procs"].append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "worker", json.dumps(spec)],
                    env=dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                             RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2"),
                    stdout=fh, stderr=subprocess.STDOUT,
                ))
            pair["outs"].append(out)
            pair["logs"].append(log)
    except BaseException:
        _kill(pair["procs"])
        raise
    return pair


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_pair(pair):
    """Wait for both processes of `pair` -> (wall seconds, [each process's
    result]). A process that exits non-zero, or a pair that outlives its
    timeout, gets both killed and raises with the end of its output: a
    gloo peer left waiting at a barrier would hang on."""
    procs = pair["procs"]
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r = bad[0]
                raise RuntimeError(f"{pair['tag']}: process {r} exited {codes[r]}:\n{_tail(pair['logs'][r])}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > pair["deadline"]:
                tails = "\n".join(f"--- process {r}:\n{_tail(log, 1500)}" for r, log in enumerate(pair["logs"]))
                raise TimeoutError(f"{pair['tag']}: the pair outlived its timeout\n{tails}")
            time.sleep(0.05)
    finally:
        _kill(procs)
    wall = time.perf_counter() - pair["t0"]
    results = []
    for out in pair["outs"]:
        with np.load(out) as z:
            results.append(dict(json.loads(str(z["info"])), labels=z["labels"]))
    return wall, results


def run_pair(ddir, mdir, kw, work, tag, device, **opts):
    """start_pair, then finish_pair."""
    return finish_pair(start_pair(ddir, mdir, kw, work, tag, device, **opts))


def single_ref(ddir, kw, device, mdir, rp=None):
    """One process (this one) over ddir, resume off, manifests into mdir of
    its own -> (labels, cluster count, seconds, launches)."""
    _paths()
    from sharp_tpu_torch import sharp_unlimited
    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.parallel import streaming

    real = patched_rp(streaming, np.load(rp)) if rp else None
    linkage_cuda.LAUNCHES.update(dict.fromkeys(linkage_cuda.LAUNCHES, 0))
    try:
        t0 = time.perf_counter()
        r = sharp_unlimited(ddir, multihost=False, resume=False, manifest_dir=mdir, device=device, **kw)
        seconds = time.perf_counter() - t0
    finally:
        if real is not None:
            streaming.ensemble_rp_matrix = real
    return r.pred_clusters, int(r.N_pred_cluster), seconds, dict(linkage_cuda.LAUNCHES)


def _same(a, b, what):
    if a.shape != b.shape or not np.array_equal(a, b):
        diff = int((a != b).sum()) if a.shape == b.shape else f"shapes {a.shape}, {b.shape}"
        raise AssertionError(f"{what}: the labels differ ({diff})")


def _hold(name, ddir, y, kw, work, device, *, resume, rp=None, threads=None, timeout=1800, reference=None,
          min_ari=None, max_clusters=None, kernels=()):
    """The two-process runs of one configuration and their checks -> (record,
    runs). reference(ddir, kw) -> (labels, cluster count) runs while the cold
    pair runs (a test's other package); without it the port's one process
    runs after the pairs."""
    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.parallel.multihost import block_slice

    on_card = device != "cpu"
    mdir = os.path.join(work, f"manifest_{name}")
    opts = dict(rp=rp, threads=threads, timeout=timeout)
    pair = start_pair(ddir, mdir, kw, work, f"{name}_cold", device, **opts)
    try:
        ref = reference(ddir, kw) if reference else None
    except BaseException:
        _kill(pair["procs"])
        raise
    cold_s, cold = finish_pair(pair)
    combined = np.concatenate([p["labels"] for p in cold])
    if cold[0]["n"] != cold[1]["n"]:
        raise AssertionError(f"{name}: the processes disagree on the cluster count: {cold[0]['n']}, {cold[1]['n']}")
    for rank, p in enumerate(cold):
        mine = len(block_slice(N_BLOCKS, rank, 2))
        if p["blocks_run"] != mine:
            raise AssertionError(f"{name}: process {rank} ran {p['blocks_run']} blocks, not its {mine}")
        missing = [k for k in kernels if p["launches"][k] < 1]
        if on_card and missing:
            raise AssertionError(f"{name}: process {rank}'s cold run never launched {missing}: {p['launches']}")
    manifests = sorted(os.listdir(mdir))
    prints = {f.rsplit("_", 1)[-1] for f in manifests}
    if len(manifests) != N_BLOCKS or len(prints) != 1:
        raise AssertionError(f"{name}: {len(manifests)} manifests, fingerprints {sorted(prints)}")
    runs = dict(cold=cold, ddir=ddir, y=y)
    rec = dict(config=name, device=device, n_blocks=N_BLOCKS, n_cells=int(len(combined)),
               declared_n_cells=int(kw.get("n_cells", len(combined))), knobs=kw,
               n_clusters=cold[0]["n"], manifests_written=len(manifests), cold_seconds=cold_s,
               cold_worker_seconds=[p["seconds"] for p in cold],
               cold_summary_gather_seconds=[p["stages"]["summary_gather"] for p in cold],
               cold_launches=[p["launches"] for p in cold])

    if resume:
        stamps = runs["manifest_stamps"] = {f: os.stat(os.path.join(mdir, f)).st_mtime_ns for f in manifests}
        resume_s, again = run_pair(ddir, mdir, kw, work, f"{name}_resume", device, **opts)
        runs["resume"] = again
        _same(np.concatenate([p["labels"] for p in again]), combined, f"{name}: resume against cold")
        for rank, p in enumerate(again):
            outside = {k: v - p["fuse_launches"][k] for k, v in p["launches"].items() if v != p["fuse_launches"][k]}
            fused = sum(p["fuse_launches"][k] for k in LINKAGE_KERNELS)
            if p["blocks_run"] or outside or (on_card and (fused < 1 or p["fuse_launches"]["cutree"] < 1)):
                raise AssertionError(f"{name}: resume process {rank} ran {p['blocks_run']} blocks, launched {outside} "
                                     f"outside the global fuse and {p['fuse_launches']} in it")
        if {f: os.stat(os.path.join(mdir, f)).st_mtime_ns for f in os.listdir(mdir)} != stamps:
            raise AssertionError(f"{name}: the resume run rewrote the manifests")
        rec.update(resume_equals_cold=True, resume_seconds=resume_s,
                   resume_worker_seconds=[p["seconds"] for p in again],
                   resume_summary_gather_seconds=[p["stages"]["summary_gather"] for p in again],
                   resume_launches=[p["launches"] for p in again])

    if ref is None:
        labels, n, single_s, launches = single_ref(ddir, kw, device, os.path.join(work, f"manifest_{name}_single"), rp)
        rec.update(single_process_seconds=single_s, single_process_launches=launches)
    else:
        labels, n = ref
    runs["single"] = (labels, n)
    _same(np.asarray(labels), combined, f"{name}: one process against two")
    if n != cold[0]["n"]:
        raise AssertionError(f"{name}: one process found {n} clusters, two {cold[0]['n']}")
    score = ari(y, combined)
    rec.update(two_process_equals_single_process=True, ari_vs_planted=score)
    if min_ari is not None and score < min_ari:
        raise AssertionError(f"{name}: ARI {score:.4f} < {min_ari}")
    if max_clusters is not None and cold[0]["n"] > max_clusters:
        raise AssertionError(f"{name}: {cold[0]['n']} clusters > {max_clusters}")
    return rec, runs


def run_mechanics(work, device, *, n_genes=N_GENES, block_cells=BLOCK_CELLS, kw=KW, **opts):
    """(a): n_cells declared 1,306,127; cold, resume and one-process runs."""
    ddir = os.path.join(work, "blocks_mech")
    y = make_dataset(ddir, n_genes=n_genes, block_cells=block_cells)
    return _hold("mechanics", ddir, y, dict(kw, n_cells=DECLARED_CELLS), work, device, resume=True,
                 kernels=("ward_serial", "cutree"), **opts)


def run_quality(work, device, *, n_genes=QUAL_GENES, block_cells=BLOCK_CELLS, kw=KW_Q, min_ari=QUAL_MIN_ARI,
                **opts):
    """(b): n_cells as the blocks hold; ARI >= min_ari, one process = two."""
    ddir = os.path.join(work, "blocks_qual")
    y = make_dataset(ddir, n_types=QUAL_TYPES, n_genes=n_genes, block_cells=block_cells)
    return _hold("quality", ddir, y, dict(kw), work, device, resume=False, min_ari=min_ari,
                 kernels=("ward_serial", "cutree"), **opts)


def cpu_draws_witness(ddir, y, work, kw=KW_Q, n_genes=QUAL_GENES):
    """(b) in one process on the card with the RP matrix the CPU draws for
    kw, injected, against (b) in one process on the CPU with its own draws:
    identical labels, so that the card's and the CPU's (b) differ only in
    their draws (CUDA and CPU generators give different streams for one
    seed) -> record."""
    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.ops.rp import ensemble_rp_matrix

    rp = os.path.join(work, "rp_cpu_draws.npy")
    np.save(rp, ensemble_rp_matrix(kw["rN_seed"], kw["ensize_K"], n_genes, kw["reduced_ndim"], device="cpu").numpy())
    card, n_card, card_s, _ = single_ref(ddir, kw, "cuda", os.path.join(work, "manifest_witness_card"), rp)
    cpu, n_cpu, cpu_s, _ = single_ref(ddir, kw, "cpu", os.path.join(work, "manifest_witness_cpu"))
    _same(np.asarray(card), np.asarray(cpu), "quality: the card with the CPU's draws against the CPU")
    if n_card != n_cpu:
        raise AssertionError(f"quality: the card with the CPU's draws found {n_card} clusters, the CPU {n_cpu}")
    return dict(cpu_draws_clusters=n_card, cpu_draws_ari=ari(y, card), cpu_draws_card_seconds=card_s,
                cpu_seconds=cpu_s)


def run_flagship(work, device="cuda", **opts):
    """(c): the bench's 26 SBLK blocks from io.benchdata's cache (made where
    missing, one process a core at once), its knobs and full-scale gates;
    every kernel launched in each process's cold run."""
    _paths()
    from sharp_tpu_torch.io import benchdata

    n_cells = sum(FLAGSHIP_BLOCKS)
    ddir = benchdata.dataset_dir(n_cells, FLAGSHIP_GENES, FLAGSHIP_TYPES, FLAGSHIP_NNZ)
    gen_s = benchdata.make_blocks(ddir, FLAGSHIP_BLOCKS, FLAGSHIP_GENES, FLAGSHIP_TYPES, FLAGSHIP_NNZ)
    y = np.concatenate([benchdata.block_y(bi, bn, FLAGSHIP_TYPES) for bi, bn in enumerate(FLAGSHIP_BLOCKS)])
    rec, runs = _hold("flagship", ddir, y, dict(KW_F, n_cells=n_cells), work, device, resume=True,
                      min_ari=FLAGSHIP_MIN_ARI, max_clusters=math.ceil(1.5 * FLAGSHIP_TYPES), kernels=KERNELS,
                      **opts)
    rec.update(datagen_seconds=gen_s, dataset_dir=ddir)
    return rec, runs


RUNS = dict(mechanics=run_mechanics, quality=run_quality, flagship=run_flagship)


def nvidia_smi():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def summary(rec):
    """One line of a record's walls: cold, resume and one process, each
    worker's seconds and summary_gather."""
    parts = [f"cold {rec['cold_seconds']:.3f} s (workers {rec['cold_worker_seconds'][0]:.3f}, "
             f"{rec['cold_worker_seconds'][1]:.3f}; summary_gather {rec['cold_summary_gather_seconds'][0]:.4f}, "
             f"{rec['cold_summary_gather_seconds'][1]:.4f})"]
    if "resume_seconds" in rec:
        parts.append(f"resume {rec['resume_seconds']:.3f} s (workers {rec['resume_worker_seconds'][0]:.3f}, "
                     f"{rec['resume_worker_seconds'][1]:.3f}; summary_gather "
                     f"{rec['resume_summary_gather_seconds'][0]:.4f}, {rec['resume_summary_gather_seconds'][1]:.4f})")
    if "single_process_seconds" in rec:
        parts.append(f"one process {rec['single_process_seconds']:.3f} s")
    if "cpu_draws_clusters" in rec:
        parts.append(f"one process with the CPU's draws {rec['cpu_draws_card_seconds']:.3f} s, the CPU's labels "
                     f"({rec['cpu_draws_clusters']} clusters, ARI {rec['cpu_draws_ari']:.4f}; the CPU "
                     f"{rec['cpu_seconds']:.3f} s)")
    return (f"[{rec['config']}] {rec['n_cells']} cells in {rec['n_blocks']} blocks, {rec['n_clusters']} clusters, "
            f"ARI {rec['ari_vs_planted']:.4f}: " + "; ".join(parts))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--config", choices=CONFIGS, action="append",
                    help="run this configuration (repeatable); default: all the device supports")
    ap.add_argument("--quality-only", dest="config", action="append_const", const="quality",
                    help="the same as --config quality (the JAX script's flag)")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("multihost_26block_torch: torch.cuda.is_available() is False; pass --device cpu",
              file=sys.stderr)
        return 1
    configs = list(dict.fromkeys(args.config or CONFIGS))
    if args.device == "cpu":
        if args.config and "flagship" in args.config:
            ap.error("the flagship configuration runs on the card only")
        configs = [c for c in configs if c != "flagship"]
    _paths()
    smi = None
    if args.device == "cuda":
        from sharp_tpu_torch.ops import _build

        smi = nvidia_smi()
        print(f"[device] {smi}; kernels built in {_build.build_report().seconds:.2f} s", flush=True)
    outdir = os.path.join(REPO, "chiprun_out")
    os.makedirs(outdir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="sharp_mh26_torch_")
    try:
        for name in configs:
            rec, runs = RUNS[name](work, args.device)
            if name == "quality" and args.device == "cuda":
                rec.update(cpu_draws_witness(runs["ddir"], runs["y"], work))
            rec["nvidia_smi"] = smi
            print(summary(rec), flush=True)
            with open(os.path.join(outdir, f"multihost_26block_torch_{name}.json"), "w") as fh:
                json.dump(rec, fh, indent=1)
            print(json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "worker":
        worker(json.loads(sys.argv[2]))
    else:
        sys.exit(main())

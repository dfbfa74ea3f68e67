#!/usr/bin/env python3
"""The collective census of every applicable cell of the chosen
shapes (train_4k by default; `--shapes prefill_32k,decode_32k,
long_500k` for the serving cells), the port's beside the reference's:
bytes a device a step by kind, on the production 16x16 and 2x16x16
meshes.

    python3 tests/torch_census_table.py port --device cuda --out DIR
    PYTHONPATH=src python tests/torch_census_table.py reference --out DIR
    python3 tests/torch_census_table.py shapes --arch A --out DIR
    PYTHONPATH=src python tests/torch_census_table.py hlo --arch A --out DIR \
        [--partitioned]
    python3 tests/torch_census_table.py table --port DIR --ref DIR
    python3 tests/torch_census_table.py compare --before DIR --after DIR
    python3 tests/torch_census_table.py predict [--shapes S1,S2,...]

`port`, `reference` and `table` take `--shapes S1,S2,...`, `shapes`
and `hlo` one `--shape S`.

- `port` (torch only: runs on the card's machine, which it uses no card
  of) runs `python -m repro_torch.launch.dryrun --arch A --shape S
  [--multi-pod] --device D` for every applicable cell, `--jobs` at a
  time, each writing `DIR/<arch>_<mesh>/dryrun_<mesh>.json`.
- `reference` (the JAX package on the CPU) runs the reference's
  `run_cell(A, S, multi_pod, extrapolate=True)` a cell a process that
  imported `repro.launch.dryrun` first (its XLA flags): on 16x16 what
  `python -m repro.launch.dryrun --arch A --shape S` runs, on 2x16x16
  with the depth extrapolation the CLI leaves out there.  A cell over
  REF_TIMEOUT_S is recorded as cut.
- `shapes` (torch only) and `hlo` (the JAX package) group one cell's
  collectives by kind, type and shape, largest first, the port's
  census and the reference's partitioned HLO at full depth (a scanned
  stack's body once); `hlo` marks the shapes that hold the vocabulary.
- `table` prints the markdown table of both censuses, kind by kind,
  and their ratio; `--gloo DIR` adds a `port --device cpu` sweep's
  totals; a decode cell's row ends with its cache's GB a device
  (`launch.cells.cache_bytes`).
- `compare` prints two `port` sweeps beside each other, kind by kind
  (an older tree's and a newer one's).
- `predict` prints each cell's census change, GB a device, when the
  residual stream goes from whole over "model" to sharded by sequence
  there (`rules.ACT_TOKENS_SEQ`), by `_seq_stream_delta`'s count.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402

MESHES = {False: "16x16", True: "2x16x16"}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
PORT_TIMEOUT_S = 900
REF_TIMEOUT_S = 600
TOP = 30


def cells(shapes: str) -> list:
    """(arch, shape, multi_pod) of every applicable cell of `shapes`
    (comma-separated), shape by shape, 16x16 before 2x16x16."""
    return [(a, s, mp) for s in shapes.split(",") for mp in (False, True)
            for a in ARCH_IDS
            if shape_applicable(get_config(a), SHAPES[s])[0]]


def _ref_name(arch: str, shape: str, mesh: str) -> str:
    """The reference's record of a cell (train_4k's keep their names)."""
    return f"{arch}_{mesh}.json" if shape == "train_4k" \
        else f"{arch}_{shape}_{mesh}.json"
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))

_REF_CELL = """
import json, sys
import repro.launch.dryrun  # noqa: F401  (its XLA flags: 512 host devices)
from repro.launch.cells import run_cell
res = run_cell(sys.argv[1], sys.argv[3], sys.argv[2] == "1", extrapolate=True)
print("RECORD " + json.dumps(res.to_json(), default=float))
"""


def _run(cmd: list, timeout: float) -> tuple:
    """(exit code or None if cut, output, seconds) of `cmd`."""
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, env=ENV,
                           cwd=ROOT, timeout=timeout)
        rc, text = r.returncode, r.stdout + r.stderr
    except subprocess.TimeoutExpired:
        rc, text = None, f"cut at {timeout} s"
    return rc, text, time.perf_counter() - t0


def port(args) -> int:
    def one(cell):
        arch, shape, mp = cell
        rc, text, wall = _run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--device", args.device, "--out",
             str(Path(args.out) / f"{arch}_{MESHES[mp]}")]
            + (["--multi-pod"] if mp else []), PORT_TIMEOUT_S)
        print(json.dumps({"arch": arch, "shape": shape, "mesh": MESHES[mp],
                          "rc": rc, "wall_s": wall,
                          "tail": text[-1500:] if rc else ""}), flush=True)
        return rc == 0

    with ThreadPoolExecutor(args.jobs) as pool:
        return 0 if all(list(pool.map(one, cells(args.shapes)))) else 1


def reference(args) -> int:
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for arch, shape, mp in cells(args.shapes):
        path = out / _ref_name(arch, shape, MESHES[mp])
        if path.exists():
            continue
        rc, text, wall = _run([sys.executable, "-c", _REF_CELL, arch,
                               str(int(mp)), shape], REF_TIMEOUT_S)
        rec = {"arch": arch, "shape": shape, "mesh": MESHES[mp],
               "ok": False}
        found = [ln for ln in text.splitlines() if ln.startswith("RECORD ")]
        if found:
            rec.update(json.loads(found[-1][len("RECORD "):]))
        else:
            rec["error"] = f"exit {rc}: {text[-300:]}"
        rec["wall_s"] = wall
        path.write_text(json.dumps(rec, indent=1))
        print(json.dumps({k: rec.get(k) for k in
                          ("arch", "shape", "mesh", "ok", "wall_s",
                           "error")}), flush=True)
    return 0


def _groups_out(args, name: str, res: dict) -> int:
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    res["by_shape"] = dict(sorted(res["by_shape"].items(),
                                  key=lambda kv: -kv[1][1]))
    (out / f"{name}_{args.arch}_{args.shape}_{MESHES[args.multi_pod]}"
     ".json").write_text(
        json.dumps(res, indent=1))
    for key, (n, nbytes) in list(res["by_shape"].items())[:TOP]:
        print(f"{nbytes / 1e9:10.3f} GB {n:6d} x {key}")
    return 0


def shapes(args) -> int:
    """The port's census of `--arch` on a fake mesh of `--device`'s
    type, by "<kind> <dtype><shape>" of each collective's output."""
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_production_mesh

    census = cells.CollectiveCensus()
    cells.fake_census(get_config(args.arch), SHAPES[args.shape],
                      make_production_mesh(multi_pod=args.multi_pod),
                      cells.train_config(), args.device, census)
    return _groups_out(args, f"port_{args.device}", {
        "arch": args.arch, "census": census.result(),
        "by_shape": census.by_shape})


def hlo(args) -> int:
    """The reference's partitioned HLO of `--arch` at full depth, its
    collectives by "<kind> <type>[<shape>]" as `parse_collective_bytes`
    counts them; "(vocab)" marks a shape holding the vocabulary or its
    16th.  By default the compiled module; with `--partitioned` the
    module right after SPMD partitioning (an XLA dump under `--out`),
    before the CPU backend promotes bf16 all-reduces to f32
    (`all-reduce-promotion`) and every bf16 collective after them
    (`float-normalization-bf16`): the types the partitioner chose."""
    import repro.launch.dryrun  # noqa: F401  (XLA flags first)
    import jax

    dump = Path(args.out) / f"xla_dump_{args.arch}_{args.shape}"
    if args.partitioned:
        shutil.rmtree(dump, ignore_errors=True)
        os.environ["XLA_FLAGS"] += (f" --xla_dump_to={dump}"
                                    " --xla_dump_hlo_pass_re=spmd-partitioning")
        jax.config.update("jax_enable_compilation_cache", False)

    from repro.configs import get_config
    from repro.configs.base import SHAPES
    from repro.launch.cells import _HLO_RE, _lower_cell, parse_collective_bytes
    from repro.launch.mesh import make_production_mesh

    cfg = get_config(args.arch)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    shape = SHAPES[args.shape]
    with getattr(jax.sharding, "set_mesh", lambda m: m)(mesh):
        text = _lower_cell(cfg, shape, mesh, shape.mode,
                           unroll=False).compile().as_text()
    if args.partitioned:
        text = max(dump.glob("*after_spmd-partitioning*.txt"),
                   key=lambda f: f.stat().st_size).read_text()
    vocab = {str(cfg.vocab_size), str(cfg.vocab_size // 16)}
    groups: dict[str, list] = {}
    for m in _HLO_RE.finditer(text):
        key = f"{m.group(3)} {m.group(1)}[{m.group(2)}]" + (
            " (vocab)" if vocab & set(m.group(2).split(",")) else "")
        seen = groups.setdefault(key, [0, 0.0])
        seen[0] += 1
        seen[1] += parse_collective_bytes(m.group(0) + ")")["total"]
    return _groups_out(args, "hlo_partitioned" if args.partitioned
                       else "hlo", {
        "arch": args.arch, "census": parse_collective_bytes(text),
        "by_shape": groups})


def _record(d: Path, arch: str, shape: str, mesh: str) -> dict:
    path = d / f"{arch}_{mesh}" / f"dryrun_{mesh}.json"
    return json.loads(path.read_text()).get(f"{arch}|{shape}", {}) \
        if path.exists() else {}


def _gb(x) -> str:
    return f"{x / 1e9:.2f}"


def table(args) -> int:
    """A row a cell: each kind and the total as port / reference in GB
    a device, the ratio, the operations, the port's seconds (`lower_s`
    + `compile_s`), with `--gloo` the gloo sweep's total and seconds,
    the reference's wall seconds, and a decode cell's cache GB a
    device.  The reference's `total` is clamped key by key to its
    full-depth count, so it may fall below its kinds' sum: the table
    sums the kinds and notes the other."""
    from repro_torch.launch import cells as T_cells
    from repro_torch.launch.mesh import make_production_mesh

    port_dir, ref_dir = Path(args.port), Path(args.ref)
    gloo = Path(args.gloo) if args.gloo else None
    print("| cell | " + " | ".join(KINDS) + " | total | port / ref | ops "
          "| port s |" + (" gloo total, s |" if gloo else "")
          + " ref s | cache GB |")
    print("|" + " --- |" * (len(KINDS) + 7 + bool(gloo)))
    for arch, shape, mp in cells(args.shapes):
        mesh = MESHES[mp]
        name = f"{arch} {mesh}" if shape == "train_4k" \
            else f"{arch} {shape} {mesh}"
        got = _record(port_dir, arch, shape, mesh)
        ref_path = ref_dir / _ref_name(arch, shape, mesh)
        want = json.loads(ref_path.read_text()) if ref_path.exists() else {}
        a, b = got.get("collectives"), want.get("collectives")
        if not a or not b:
            why = [f"{side}: {rec.get('error') or 'not run'}"[:60]
                   for side, rec, c in (("port", got, a),
                                        ("reference", want, b)) if not c]
            print(f"| {name} | " + "; ".join(why)
                  + " |" * (len(KINDS) + 6))
            continue
        ta, tb = (sum(c[k] for k in KINDS) for c in (a, b))
        note = "" if abs(b["total"] - tb) <= 0.01 * tb \
            else f" (reported {b['total'] / 1e9:.3g})"
        row = (f"| {name} | "
               + " | ".join(f"{_gb(a[k])} / {_gb(b[k])}" for k in KINDS)
               + f" | {_gb(ta)} / {_gb(tb)}{note} | "
               + (f"{ta / tb:.2f}" if tb else "-")
               + f" | {int(a['n_ops'])} / {int(b['n_ops'])}"
               f" | {got['lower_s']:.1f} + {got['compile_s']:.1f} |")
        if gloo:
            g = _record(gloo, arch, shape, mesh)
            row += (f" {_gb(g['collectives']['total'])}, {g['lower_s']:.1f}"
                    f" + {g['compile_s']:.1f} |" if g.get("collectives")
                    else f" {(g.get('error') or 'not run')[:40]} |")
        cache = ""
        if SHAPES[shape].mode == "decode":
            cache = _gb(T_cells.cache_bytes(
                get_config(arch), SHAPES[shape],
                make_production_mesh(multi_pod=mp)))
        print(row + f" {want['wall_s']:.0f} | {cache} |")
    return 0


def compare(args) -> int:
    """A row a cell of two `port` sweeps of the same shapes and plans
    (`--before`, `--after`): each kind and the total as before -> after
    in GB a device, and the total's ratio, "(equal)" where the two
    censuses are the same to the byte and in operations."""
    before, after = Path(args.before), Path(args.after)
    print("| cell | " + " | ".join(KINDS) + " | total | after / before |")
    print("|" + " --- |" * (len(KINDS) + 3))
    for arch, shape, mp in cells(args.shapes):
        mesh = MESHES[mp]
        name = f"{arch} {mesh}" if shape == "train_4k" \
            else f"{arch} {shape} {mesh}"
        a, b = (_record(d, arch, shape, mesh).get("collectives")
                for d in (before, after))
        if not a or not b:
            print(f"| {name} | " + ("before" if not a else "after")
                  + " not counted |" + " |" * (len(KINDS) + 1))
            continue
        ratio = f"{b['total'] / a['total']:.3f}" if a["total"] else "-"
        ratio += " (equal)" if a == b else ""
        print(f"| {name} | " + " | ".join(
            f"{_gb(a[k])} -> {_gb(b[k])}" for k in KINDS)
            + f" | {_gb(a['total'])} -> {_gb(b['total'])} | {ratio} |")
    return 0


def _seq_stream_delta(cfg, shape, multi_pod: bool) -> float:
    """Bytes a device a step the census gains (negative: loses) when
    the stream between products lies sharded by sequence over "model"
    (m ranks) instead of whole, T the stream's (rows, S, d_model) and
    Tq the attention output's (rows, S, q_dim) in the compute type.
    Each sublayer with a row-parallel sum (attention's and the
    cross-attention's `wo`, the FFN's `w_down`, the MoE's output, the
    SSD's `w_out`): before, an all-reduce (2T) in the forward and in
    remat's recompute of every sublayer but a period's last; after, a
    gather at its entry (T) in the forward, the recompute and the
    backward (the reduce-scatter's), reduce-scatters (T / m) in the
    forward, the recompute but the last sublayer's, and the backward
    (the gather's).  Each attention's output: before gathered whole
    (Tq) in the forward and the recompute; after an all-to-all (Tq /
    m) in the forward, the recompute and the backward.  Once a step:
    the final norm's gather (T) and its reduce-scatter, and the
    embedding's gradient gathered (T, not for frames).  A prefill
    (no backward, no recompute): an all-reduce (2T) becomes a gather
    (T) and a reduce-scatter (T / m), the attention output's gather
    (Tq) an all-to-all (Tq / m), and the final norm's gather (T) is
    added.  Decode steps and a sequence "model" does not divide: 0.
    The parent's own backward plans around a gradient left partial
    over "model" are not counted."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.lm import period_layout

    mesh = make_production_mesh(multi_pod=multi_pod)
    m = mesh["model"]
    ways = mesh.get("pod", 1) * mesh["data"]
    if shape.mode == "decode" or shape.seq_len % m:
        return 0.0
    rows = shape.global_batch // ways if shape.global_batch % ways == 0 \
        else shape.global_batch
    elem = rows * shape.seq_len * dtype_of(cfg.compute_dtype).itemsize
    t, tq = elem * cfg.d_model, elem * cfg.q_dim
    subs = []           # (attention output?) a sublayer, in order
    for slot in period_layout(cfg):
        subs.append(slot.kind == "attn")
        if slot.cross:
            subs.append(True)
        if (slot.kind == "attn" or cfg.family == "hybrid") \
                and (slot.moe or cfg.d_ff > 0):
            subs.append(False)
    n_periods = cfg.n_layers // len(period_layout(cfg))
    if shape.mode != "train":
        per = sum(t + t / m - 2 * t + (tq / m - tq if attn else 0.0)
                  for attn in subs)
        return n_periods * per + t
    per = 0.0
    for i, attn in enumerate(subs):
        if cfg.remat:       # the recompute stops before a period's last sum
            r = int(i < len(subs) - 1)
            before = 2 * t * (1 + r) + (2 * tq if attn else 0.0)
            after = 3 * t + t / m * (2 + r) + (3 * tq / m if attn else 0.0)
        else:
            before = 2 * t + (tq if attn else 0.0)
            after = 2 * t + 2 * t / m + (2 * tq / m if attn else 0.0)
        per += after - before
    return n_periods * per + t + t / m + (t if cfg.modality != "audio"
                                          else 0.0)


def predict(args) -> int:
    """A row a cell: `_seq_stream_delta` in GB a device."""
    print("| cell | predicted change GB |")
    print("| --- | --- |")
    for arch, shape, mp in cells(args.shapes):
        name = f"{arch} {MESHES[mp]}" if shape == "train_4k" \
            else f"{arch} {shape} {MESHES[mp]}"
        delta = _seq_stream_delta(get_config(arch), SHAPES[shape], mp)
        print(f"| {name} | {delta / 1e9:+.2f} |")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("port")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", required=True)
    p.add_argument("--jobs", type=int, default=4)
    r = sub.add_parser("reference")
    r.add_argument("--out", required=True)
    for name in ("shapes", "hlo"):
        b = sub.add_parser(name)
        b.add_argument("--arch", required=True)
        b.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
        b.add_argument("--multi-pod", action="store_true")
        b.add_argument("--out", required=True)
        b.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        b.add_argument("--partitioned", action="store_true",
                       help="hlo: the module after SPMD partitioning")
    t = sub.add_parser("table")
    t.add_argument("--port", required=True)
    t.add_argument("--ref", required=True)
    t.add_argument("--gloo", default="")
    c = sub.add_parser("compare")
    c.add_argument("--before", required=True)
    c.add_argument("--after", required=True)
    pr = sub.add_parser("predict")
    for sp in (p, r, t, c, pr):
        sp.add_argument("--shapes", default="train_4k",
                        help="comma-separated shapes")
    args = ap.parse_args()
    return {"port": port, "reference": reference, "shapes": shapes,
            "hlo": hlo, "table": table, "compare": compare,
            "predict": predict}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

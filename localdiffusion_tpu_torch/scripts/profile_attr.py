"""Group the card's kernel time in a trace by UNet stage.

    python -m localdiffusion_tpu_torch.scripts.profile_attr <trace dir or trace.json>
        [--top 30] [--stage NAME] [--ops] [--json out.json]
    python -m localdiffusion_tpu_torch.scripts.profile_attr --run mri256_bf16
        [--batch 4] [--calls 5] [--params-npz results/mri_synth256_ema.npz]
        [--out-dir results_torch] [--device cuda|cpu]

The port of `scripts/profile_attr.py`.  It reads the Chrome trace that
`utils.logging.profile_trace` writes (`<dir>/trace.json`): inside such a
session the UNet runs each stage in a `record_function` scope of its JAX
module path (`models/unet.py`: `init_conv`, `time_mlp`, `down0_block1`, …,
`mid_attn`, `cond_model`, `conv_fusion`, `up0_block1`, …, `final_conv`).
Each kernel on the card is attributed to the innermost stage scope that
holds its launch on the launching thread (the launch's `correlation` id
ties the two), and each kernel's name gives its category.  A trace without
device activity (a CPU run) attributes the top-level CPU operators the
same way.  Stages, categories and stage × category pairs print with their
share of the total; every event lands in one stage ("(unattributed)" for
time outside every scope, such as the UNet's concatenations and residual
sums), so the shares sum to the total.

`--run <config>` records a trace first: `--calls` UNet calls at `--batch`
rows of the named configuration (`config.load_config`: a builder name, a
.json or a .yaml; the shipped 256px weights by default, seeded random
weights with `--params-npz none`) under `profile_trace`, on the card unless
`--device cpu`, and writes the attribution with the card's name and power
limit to `<out-dir>/profile_attr_<config>.json`.  Use only `profile_trace`
for the trace: a bare profiler session in a process older than ~50 s may
lose the card's activity (`utils.logging.profile_trace`).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import re
import sys

_STAGE_RE = re.compile(
    r"(init_conv|time_mlp|down\d+_\w+|up\d+_\w+|mid_block\d|mid_attn|cond_model|"
    r"conv_fusion|final_res_block|final_conv)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UNATTRIBUTED = "(unattributed)"


def find_trace_file(path: str) -> str:
    """`path` itself, or the newest `trace.json` / `*.json` under it."""
    if os.path.isfile(path):
        return path
    hits = []
    for root, _dirs, files in os.walk(path):
        hits += [os.path.join(root, f) for f in files if f.endswith(".json")]
    if not hits:
        raise FileNotFoundError(f"no Chrome trace under {path}")
    named = [h for h in hits if os.path.basename(h) == "trace.json"]
    return max(named or hits, key=os.path.getmtime)


def load_events(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data.get("traceEvents", data) if isinstance(data, dict) else data


def category(name: str) -> str:
    """A kernel's or an operator's category: the port's kernels by their
    source, cuDNN/cuBLAS by library, PyTorch's by their kind, else the
    function's own name (without its namespace, template and arguments)."""
    low = name.lower()
    for key, cat in (("kv_kernel", "linear_attention"), ("q_kernel", "linear_attention"),
                     ("flash", "flash_attention"), ("gn_", "groupnorm"),
                     ("groupnorm", "groupnorm"), ("conv3x3", "resnet_block"),
                     ("epilogue", "resnet_block"), ("xmma", "cudnn/cublas"),
                     ("cudnn", "cudnn/cublas"), ("cutlass", "cudnn/cublas"),
                     ("gemm", "cudnn/cublas"), ("nvjet", "cudnn/cublas"),
                     ("moments", "F.group_norm"), ("copy", "copy"), ("elementwise", "elementwise"),
                     ("reduce", "reduction"), ("memset", "memset")):
        if key in low:
            return cat
    base = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name.strip())
    base = re.split(r"[<(]", base, maxsplit=1)[0]
    return base.split("::")[-1][:40] or name[:40]


def _stage_index(events) -> dict:
    """{(pid, tid): sorted [(ts, end, name)]} of the stage scopes."""
    by_thread = collections.defaultdict(list)
    for ev in events:
        if (ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                and _STAGE_RE.fullmatch(str(ev.get("name", "")))):
            ts = float(ev["ts"])
            by_thread[(ev.get("pid"), ev.get("tid"))].append((ts, ts + float(ev.get("dur", 0)),
                                                              ev["name"]))
    return {k: sorted(v) for k, v in by_thread.items()}


def _stage_at(index, thread, ts: float) -> str:
    """The innermost (latest-starting) stage scope of `thread` holding ts."""
    scopes = index.get(thread, ())
    i = bisect.bisect_right(scopes, (ts, float("inf"), "")) - 1
    while i >= 0:
        start, end, name = scopes[i]
        if start <= ts <= end:
            return name
        i -= 1
    return UNATTRIBUTED


def _top_level_ops(events) -> list:
    """CPU operators not inside another operator of their thread."""
    ops = sorted((ev for ev in events if ev.get("ph") == "X" and ev.get("cat") == "cpu_op"),
                 key=lambda e: (e.get("pid"), e.get("tid"), float(e["ts"]),
                                -float(e.get("dur", 0))))
    out, end, thread = [], -1.0, None
    for ev in ops:
        t = (ev.get("pid"), ev.get("tid"))
        ts = float(ev["ts"])
        if t != thread:
            thread, end = t, -1.0
        if ts >= end:
            out.append(ev)
            end = ts + float(ev.get("dur", 0))
    return out


def attribute(events, stage=None) -> dict:
    """{'device': 'cuda' or 'cpu', 'events', 'total_us', 'by_stage',
    'by_category', 'by_stage_category', 'by_op'}: the kernels' time (or, in
    a trace without device activity, the top-level CPU operators'), each
    event in the stage scope that holds its launch.  `stage` keeps one
    stage's events only."""
    index = _stage_index(events)
    kernels = [ev for ev in events if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]
    items = []  # (name, dur, thread, ts of the launch)
    if kernels:
        launch = {}
        for ev in events:
            corr = (ev.get("args") or {}).get("correlation")
            if ev.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch[corr] = ev
        for k in kernels:
            src = launch.get((k.get("args") or {}).get("correlation"))
            thread = None if src is None else (src.get("pid"), src.get("tid"))
            items.append((k["name"], float(k.get("dur", 0)), thread,
                          None if src is None else float(src["ts"])))
        device = "cuda"
    else:
        for op in _top_level_ops(events):
            items.append((op["name"], float(op.get("dur", 0)), (op.get("pid"), op.get("tid")),
                          float(op["ts"])))
        device = "cpu"
    by_stage, by_cat = collections.Counter(), collections.Counter()
    by_pair, by_op, n = collections.Counter(), collections.Counter(), 0
    for name, dur, thread, ts in items:
        st = UNATTRIBUTED if ts is None else _stage_at(index, thread, ts)
        if stage is not None and st != stage:
            continue
        cat = category(name)
        by_stage[st] += dur
        by_cat[cat] += dur
        by_pair[f"{st} {cat}"] += dur
        by_op[name] += dur
        n += 1
    total = sum(by_stage.values())
    return {"device": device, "events": n, "total_us": total,
            "by_stage": dict(by_stage.most_common()), "by_category": dict(by_cat.most_common()),
            "by_stage_category": dict(by_pair.most_common()), "by_op": dict(by_op.most_common())}


def report(res: dict, top: int = 30, ops: bool = False) -> str:
    total = res["total_us"]
    what = "kernel" if res["device"] == "cuda" else "top-level CPU operator"
    lines = [f"{what} time total: {total / 1e3:.3f} ms over {res['events']} events"]
    if not total:
        return lines[0]
    sections = [("by stage", "by_stage"), ("by category", "by_category"),
                ("stage x category (top)", "by_stage_category")]
    if ops:
        sections.append(("individual kernels (top)", "by_op"))
    for title, key in sections:
        lines.append(f"\n== {title} ==")
        for name, dur in list(res[key].items())[:top]:
            lines.append(f"{dur / 1e3:10.3f} ms  {100 * dur / total:5.1f}%  {name[:110]}")
    return "\n".join(lines)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", nargs="?", help="a trace.json or a directory holding one")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--stage", default=None, help="only this stage's events")
    ap.add_argument("--ops", action="store_true", help="also list the top kernels")
    ap.add_argument("--json", default=None, help="write the attribution here")
    ap.add_argument("--run", default=None, metavar="CONFIG",
                    help="record a trace of UNet calls of this configuration first")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--params-npz", default="results/mri_synth256_ema.npz",
                    help="the denoiser's weights ('none': seeded random weights)")
    ap.add_argument("--out-dir", default=None, help="default results_torch/")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if (args.trace is None) == (args.run is None):
        ap.error("give a trace or --run CONFIG, not both")
    return args


def record_trace(args) -> tuple:
    """`--calls` UNet calls of `--run`'s configuration under `profile_trace`:
    (trace path, the run's description)."""
    import numpy as np
    import torch

    from localdiffusion_tpu_torch.config import load_config
    from localdiffusion_tpu_torch.diffusion.gaussian import build_gd, resolve_device
    from localdiffusion_tpu_torch.factory import load_params
    from localdiffusion_tpu_torch.scripts import _measure as M
    from localdiffusion_tpu_torch.utils.logging import profile_trace

    device = resolve_device(args.device)
    card = M.card_record() if device.type == "cuda" else {"device": "cpu"}
    cfg = load_config(args.run)
    gd = build_gd(cfg, device=device)
    if args.params_npz != "none":
        load_params(cfg, gd, params_npz=args.params_npz, device=device)
    s, mc = gd.image_size, gd.model.cfg
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(args.batch, s, s, mc.channels)), dtype=torch.float32,
                        device=device)
    cond = torch.as_tensor(rng.uniform(0, 2, (args.batch, s, s, mc.resolved_cond_channels)),
                           dtype=torch.float32, device=device)
    t = torch.full((args.batch,), 10, device=device)
    gd.apply_model(x, cond, t)  # warm: builds and loads the kernels
    out = os.path.join(args.out_dir or "build", "profile_attr", args.run.replace("/", "_"))
    with profile_trace(out):
        for _ in range(args.calls):
            gd.apply_model(x, cond, t)
    return os.path.join(out, "trace.json"), dict(card=card, config=args.run,
                                                 batch=args.batch, calls=args.calls,
                                                 weights=args.params_npz)


def record(trace: str, run: dict, res: dict, top: int) -> dict:
    """The JSON of a `--run`: the run, the totals, every stage and
    category, and the `top` stage × category pairs and kernels."""
    cut = {k: dict(list(res[k].items())[:top]) for k in ("by_stage_category", "by_op")}
    return dict(script="profile_attr", trace=trace, **run, **dict(res, **cut))


def main(argv=None) -> dict:
    args = parse_args(argv)
    run = None
    if args.run:
        path, run = record_trace(args)
    else:
        path = find_trace_file(args.trace)
    print(f"# {path}", file=sys.stderr)
    res = attribute(load_events(path), args.stage)
    print(report(res, args.top, args.ops), flush=True)
    if run is not None:
        from localdiffusion_tpu_torch.scripts import _measure as M

        if run["card"]["device"] != "cpu":
            M.write_json(f"profile_attr_{os.path.basename(args.run).split('.')[0]}",
                         record(path, run, res, args.top), args.out_dir)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(trace=path, **res), f, indent=1)
    return res


if __name__ == "__main__":
    main()

"""Seed 6's serving-gate classifier loop (``tpusr_torch.tools.
gate_trajectory.Loop``) on the card against the CPU from one state: where
one step on the two devices parts, and whether the card leaves the ln 2
plateau from the states that the CPU leaves it from. Needs a card:

    python tests/data/gate_trajectory/same_state.py --from cpu card \\
        --out same_state.json

``--from cpu``: the CPU's own loop for ``CPU_STEPS`` steps, keeping its
state (parameters, Adam's moments and count) at each of ``CPU_STATES``. From
each kept state, one step's loss, gradients and Adam update on the card
against the CPU's, leaf by leaf, with a float64 step on the CPU as the
witness of both (``one_step``); then ``WINDOW`` steps on the card (cuDNN
deterministic, as the gate trains, and unrestricted) beside the CPU's own.
Last, the card's own loop from step 0 for ``CPU_STEPS`` steps.

``--from card``: the card's own loop (surfaces built on the card, as the
gate runs it) to step ``CARD_STATE``, and ``one_step`` from that state. Then
the card, cuDNN deterministic, runs on to step ``SEARCH_STEPS`` until a loss
falls under ``ESCAPE_LOSS``, keeping its state every ``RING`` steps. From
the kept states ``LEADS`` steps or more before that escape: ``one_step``,
and ``WINDOW_NEAR`` steps on the CPU and on the card (deterministic, which
must replay its first run, and unrestricted): which leave, and when.

It prints a line for each result and writes all of them to ``--out``.
JAX's own course on the CPU comes from ``jax_cpu.json`` beside this file.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
sys.path.insert(0, REPO)

from chip_smoke import deterministic_cudnn, jax_fixture  # noqa: E402
from tpusr_torch.tools.gate_trajectory import (ESCAPE_LOSS, Loop,  # noqa: E402
                                               first_escape)
from tpusr_torch.tools.serving_gate import card_line  # noqa: E402

SEED = 6
CPU_STEPS, CPU_STATES, WINDOW = 350, (150, 200, 250), 100
CARD_STATE, SEARCH_STEPS = 200, 1000
RING, LEADS, WINDOW_NEAR = 5, (30, 15, 5), 40


def modes(det: bool):
    """cuDNN held to deterministic algorithms (as the gate trains), or left
    unrestricted."""
    return deterministic_cudnn() if det else contextlib.nullcontext()


def snapshot(loop: Loop, device="cpu") -> dict:
    """``loop``'s state, copied to ``device``: parameters, Adam's moments
    and count, and the step."""
    st = loop.state
    return {"step": loop.step, "count": st.opt_state["count"],
            "params": {k: v.detach().to(device, copy=True)
                       for k, v in st.params.items()},
            "mu": {k: v.to(device, copy=True)
                   for k, v in st.opt_state["mu"].items()},
            "nu": {k: v.to(device, copy=True)
                   for k, v in st.opt_state["nu"].items()}}


def load(loop: Loop, snap: dict, dtype=torch.float32) -> None:
    """A copy of ``snap`` as ``loop``'s state (a step updates it in place)."""
    st = loop.state
    for k, v in snap["params"].items():
        st.params[k] = v.to(loop.device, dtype, copy=True).requires_grad_()
    st.opt_state["count"] = snap["count"]
    for part in ("mu", "nu"):
        st.opt_state[part] = {k: v.to(loop.device, dtype, copy=True)
                              for k, v in snap[part].items()}
    loop.step = snap["step"]


def window(loop: Loop, snap: dict, steps: int, det: bool = True) -> dict:
    """``steps`` steps of ``loop`` from ``snap``, and where they escape."""
    load(loop, snap)
    with modes(det):
        r = loop.run(steps)
    return {**r, "escape": first_escape(r["loss"], snap["step"])}


def _rel(a: torch.Tensor, b: torch.Tensor) -> dict:
    """|a - b| against |b|: the largest element over b's largest, and the
    norms' ratio."""
    a, b = a.double().cpu(), b.double().cpu()
    d = (a - b).abs()
    return {"max_rel": float(d.max() / b.abs().max().clamp_min(1e-300)),
            "norm_rel": float(d.norm() / b.norm().clamp_min(1e-300))}


def one_step(snap: dict, cpu: Loop, card: Loop, f64: Loop) -> dict:
    """From ``snap``, step ``snap['step']`` on the CPU, on the card (cuDNN
    deterministic) and in float64 on the CPU: the losses, each leaf's
    gradient and Adam update on the card against the CPU's, and both
    against float64's."""
    s = snap["step"]
    res = {"step": s, "loss": {}, "grad": {}, "update": {}}
    grads, updates = {}, {}
    for tag, loop, dtype in (("cpu", cpu, torch.float32),
                             ("card", card, torch.float32),
                             ("f64", f64, torch.float64)):
        load(loop, snap, dtype)
        x, y = loop.batch(s)
        with deterministic_cudnn():
            loss, _, g = loop.trainer.value_and_grad(loop.state, x.to(dtype),
                                                     y, step=s)
            before = {k: v.detach().clone() for k, v in loop.state.params.items()}
            loop.state, _ = loop.trainer.train_step(loop.state, x.to(dtype),
                                                    y, s)
        res["loss"][tag] = float(loss)
        grads[tag] = {k: v.detach().cpu() for k, v in g.items()}
        updates[tag] = {k: (loop.state.params[k].detach() - before[k]).cpu()
                        for k in before}
    for part, got in (("grad", grads), ("update", updates)):
        for name in got["cpu"]:
            res[part][name] = {
                "card_vs_cpu": _rel(got["card"][name], got["cpu"][name]),
                "cpu_vs_f64": _rel(got["cpu"][name], got["f64"][name]),
                "card_vs_f64": _rel(got["card"][name], got["f64"][name])}
    return res


def step_line(where: str, o: dict) -> str:
    g = o["grad"]
    worst = max(g, key=lambda k: g[k]["card_vs_cpu"]["norm_rel"])
    return (f"[same-state] {where}: loss CPU {o['loss']['cpu']:.6f} card "
            f"{o['loss']['card']:.6f} f64 {o['loss']['f64']:.6f}; gradient "
            f"card vs CPU worst leaf {worst} norm_rel "
            f"{g[worst]['card_vs_cpu']['norm_rel']:.3g} (CPU vs f64 "
            f"{g[worst]['cpu_vs_f64']['norm_rel']:.3g}, card vs f64 "
            f"{g[worst]['card_vs_f64']['norm_rel']:.3g})")


def loops(seed: int, card_dev, pool_on: str):
    """The card's, the CPU's and the float64 loop of ``seed`` on one pool,
    built on the CPU or on the card (``pool_on``)."""
    if pool_on == "cpu":
        cpu = Loop(seed, "cpu")
        card = Loop(seed, card_dev, pool=cpu.pool)
    else:
        card = Loop(seed, card_dev)
        cpu = Loop(seed, "cpu", pool=card.pool)
    f64 = Loop(seed, "cpu", pool=cpu.pool)
    f64.trainer.compute_dtype = torch.float64
    return cpu, card, f64


def from_cpu_states(card_dev, jl: np.ndarray) -> dict:
    """``--from cpu`` of the module docstring."""
    cpu, card, f64 = loops(SEED, card_dev, "cpu")
    t = time.perf_counter()
    run, kept = {"loss": [], "accuracy": []}, {}
    for _ in range(CPU_STEPS):
        if cpu.step in CPU_STATES:
            kept[cpu.step] = snapshot(cpu)
        for k, v in cpu.run(1).items():
            run[k] += v
    res = {"cpu_run": {**run, "escape": first_escape(run["loss"]),
                       "s_per_step": (time.perf_counter() - t) / CPU_STEPS}}
    d = np.abs(np.array(run["loss"][:3], np.float32) - jl[:3])
    res["cpu_run"]["max_abs_d_jax_steps_0_2"] = float(d.max())
    print(f"[same-state] CPU: {CPU_STEPS} steps, "
          f"{res['cpu_run']['s_per_step']:.2f} s a step; escape at step "
          f"{res['cpu_run']['escape']}; |d| from JAX over steps 0-2 "
          f"{float(d.max()):.3g}", flush=True)
    res["states"] = {}
    for s in CPU_STATES:
        entry = {"one_step": one_step(kept[s], cpu, card, f64),
                 "card_deterministic": window(card, kept[s], WINDOW, True),
                 "card_unrestricted": window(card, kept[s], WINDOW, False)}
        cpu_w = run["loss"][s:s + WINDOW]
        entry["cpu"] = {"loss": cpu_w, "escape": first_escape(cpu_w, s)}
        res["states"][str(s)] = entry
        print(step_line(f"from the CPU's state at step {s}",
                        entry["one_step"])
              + f"; escape in {WINDOW} steps: CPU {entry['cpu']['escape']}, "
              f"card deterministic {entry['card_deterministic']['escape']}, "
              f"card unrestricted {entry['card_unrestricted']['escape']}",
              flush=True)
    own = Loop(SEED, card_dev)
    pool_d = float((own.pool[0].cpu() - cpu.pool[0]).abs().max())
    with deterministic_cudnn():
        r = own.run(CPU_STEPS)
    dj = np.abs(np.array(r["loss"][:3], np.float32) - jl[:3])
    res["card_run"] = {**r, "escape": first_escape(r["loss"]),
                       "pool_max_abs_d_from_cpu": pool_d,
                       "max_abs_d_jax_steps_0_2": float(dj.max())}
    print(f"[same-state] the card's own loop (surfaces built on the card, "
          f"pool {pool_d:.3g} from the CPU's): {CPU_STEPS} steps, escape at "
          f"step {res['card_run']['escape']}; |d| from JAX over steps 0-2 "
          f"{float(dj.max()):.3g}", flush=True)
    return res


def search_escape(card: Loop, start: dict):
    """From ``start``, the card's steps (cuDNN deterministic, as the gate
    trains) to ``SEARCH_STEPS``, until one loss is under ``ESCAPE_LOSS``:
    (escape step, the states kept every ``RING`` steps on the card up to
    it, the losses from ``start``), or None."""
    load(card, start)
    ring = collections.deque(maxlen=max(LEADS) // RING + 2)
    losses = []
    with deterministic_cudnn():
        while card.step < SEARCH_STEPS:
            if card.step % RING == 0:
                ring.append(snapshot(card, card.device))
            losses += card.run(1)["loss"]
            if losses[-1] < ESCAPE_LOSS:
                return card.step - 1, list(ring), losses
    return None


def from_card_states(card_dev) -> dict:
    """``--from card`` of the module docstring."""
    cpu, card, f64 = loops(SEED, card_dev, "card")
    with deterministic_cudnn():
        head = card.run(CARD_STATE)
    start = snapshot(card, card.device)
    res = {"own_state": one_step(start, cpu, card, f64),
           "loss_head": head["loss"]}
    print(step_line(f"from the card's own state at step {CARD_STATE}",
                    res["own_state"]), flush=True)
    found = search_escape(card, start)
    if found is None:
        res["escape"] = None
        print(f"[same-state] the card from its own step {CARD_STATE} does not "
              f"leave the plateau by step {SEARCH_STEPS}", flush=True)
        return res
    esc, ring, losses = found
    res.update(escape=esc, loss_search=losses, states={})
    print(f"[same-state] the card from its own step {CARD_STATE} leaves the "
          f"plateau at step {esc}", flush=True)
    picks = sorted({max(r["step"] for r in ring if r["step"] <= esc - lead)
                    for lead in LEADS
                    if any(r["step"] <= esc - lead for r in ring)})
    for s in picks:
        snap = next(r for r in ring if r["step"] == s)
        e = {"one_step": one_step(snap, cpu, card, f64),
             "cpu": window(cpu, snap, WINDOW_NEAR),
             "card_deterministic": window(card, snap, WINDOW_NEAR, True),
             "card_unrestricted": window(card, snap, WINDOW_NEAR, False)}
        first = losses[s - CARD_STATE:s - CARD_STATE + WINDOW_NEAR]
        again = e["card_deterministic"]["loss"][:len(first)]
        e["replay_max_abs_d"] = float(np.abs(np.array(again)
                                             - np.array(first)).max())
        res["states"][str(s)] = e
        print(step_line(f"{esc - s} steps before the card's escape (step "
                        f"{s})", e["one_step"])
              + f"; escape in {WINDOW_NEAR} steps: CPU {e['cpu']['escape']}, "
              f"card deterministic {e['card_deterministic']['escape']}, card "
              f"unrestricted {e['card_unrestricted']['escape']}; the card's "
              f"deterministic replay {e['replay_max_abs_d']:.3g} from its "
              f"first run", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--from", dest="runs", nargs="+", choices=("cpu", "card"),
                    default=["cpu", "card"])
    ap.add_argument("--out", required=True, help="the JSON file to write")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("same_state: this comparison needs a card")
        return 2
    t0 = time.perf_counter()
    card_dev = torch.device("cuda", 0)
    jl, _ = jax_fixture(SEED)
    res = {"card": card_line(card_dev), "torch": torch.__version__,
           "cpu_threads": torch.get_num_threads(), "seed": SEED,
           "jax_cpu": {"steps": len(jl), "escape": first_escape(jl)}}
    print(f"[same-state] seed {SEED}: JAX on the CPU leaves the plateau at "
          f"step {res['jax_cpu']['escape']} (fixture, {len(jl)} steps)",
          flush=True)
    if "cpu" in args.runs:
        res["from_cpu"] = from_cpu_states(card_dev, jl)
    if "card" in args.runs:
        res["from_card"] = from_card_states(card_dev)
    res["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(f"[same-state] {res['card']}: {res['seconds']:.0f} s; wrote "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Command-line entry points of the port (port of ``tpusr/cli/__main__.py``).

    python -m tpusr_torch.cli serve --edsr-ckpt E --vgg16-ckpt V [...]

``serve`` stands up the HTTP serving tier on trained checkpoints, with the
JAX command's flags and defaults, plus ``--device`` (default ``cuda``):
with no card and no ``--device cpu`` the command exits with a message; it
never falls back to the CPU. The checkpoints are the port's own, saved by
``tpusr_torch.models.api``'s ``EDSR.save`` and ``FineTunedVGG16.save``.

The JAX CLI's other commands (``preprocess``, ``classic``, ``train-*``,
``pipeline``, ``convert``, ``eda``) are not ported yet (ROADMAP queue 1,
items 9-10).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GATE_FILE = "GATE_torch.json"    # the port's gate verdict, on the H100


def _gate_certification_note(args) -> str | None:
    """One-line serving-gate verdict for the selected configuration, from
    the port's own gate report (``GATE_torch.json`` at the root of the
    checkout, written by ``python -m tpusr_torch.tools.serving_gate``; None
    when it is not there). A mode the gate failed gets a warning."""
    from tpusr_torch.tools.serving_gate import gate_row_name

    if (args.sr_mode, args.clf_mode) == ("f32", "per_patch_f32"):
        return "reference-parity path (the gate's comparison baseline)"
    try:
        row = gate_row_name(args.sr_mode, args.clf_mode,
                            border=not args.no_border,
                            cascade_score=args.cascade_score,
                            cascade_frac=args.cascade_frac,
                            cascade_guard=args.cascade_guard > 0)
    except ValueError as e:
        return f"WARNING: configuration NOT gate-certified ({e})"
    path = os.path.join(_REPO, GATE_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        report = json.load(f)
    task = report.get("task", {}).get("name", "")
    modes = report["aggregate"]["modes"]
    m = next((x for x in modes if x["mode"] == row), None)
    if m is None:
        return (f"WARNING: {row} has no row in the serving gate "
                "(uncertified configuration)")
    if not m.get("passes_gate_all_seeds"):
        passing = [x["mode"] for x in modes if x.get("passes_gate_all_seeds")]
        return (f"WARNING: {row} FAILED the {task} serving gate "
                f"(min vote agreement {m['min_vote_agreement']:.4f} < 0.99, "
                f"{m['total_flips']} flips over seeds {m.get('seeds')} — "
                f"{GATE_FILE}); rows that pass every seed there: "
                f"{', '.join(passing) or 'none'}")
    return (f"{task}-gate certified: {row} (min vote agreement "
            f"{m['min_vote_agreement']:.4f}, {m['total_flips']} flips over "
            f"seeds {m.get('seeds')} — {GATE_FILE})")


def _read_calib_dir(calib_dir: str, lr_hw: tuple[int, int]):
    """Up to 16 calibration PNGs (sorted by name) as an (N, h, w, 3)
    float32 [0, 1] array, each resized to the LR size with OpenCV's
    ``INTER_AREA`` weights (``core/resize.py``) and rounded back to uint8,
    as the JAX command reads them with cv2. Only ``*.png`` is read: the
    port's codec decodes PNG alone, where the JAX command also takes JPEG."""
    import numpy as np
    import torch

    from tpusr_torch.core.resize import resize
    from tpusr_torch.pipeline.png import decode_png_u8

    files = sorted(glob.glob(os.path.join(calib_dir, "*.png")))[:16]
    if not files:
        raise SystemExit(f"--calib-dir {calib_dir}: no PNG images")
    imgs = []
    for f in files:
        with open(f, "rb") as fh:
            body = fh.read()
        try:
            u8 = decode_png_u8(body)
        except ValueError as e:
            raise SystemExit(f"--calib-dir: unreadable image {f} ({e})") from None
        if u8.shape[:2] != lr_hw:
            u8 = (resize(torch.from_numpy(u8).float(), lr_hw, "area")
                  .round().clamp(0, 255).to(torch.uint8).numpy())
        imgs.append(u8)
    return np.stack(imgs).astype(np.float32) / 255.0


def cmd_serve(args):
    """Stand up the serving tier: load trained EDSR + VGG16 checkpoints,
    build a gated ``make_serving_pipeline`` configuration, and serve HTTP
    requests with cross-request micro-batching (``PipelineServer``). Fast
    modes are validated by ``python -m tpusr_torch.tools.serving_gate``
    (``GATE_torch.json``)."""
    import numpy as np
    import torch

    from tpusr_torch.core.patches import patchify
    from tpusr_torch.device import resolve_device
    from tpusr_torch.models.api import EDSR as EDSRFacade, FineTunedVGG16
    from tpusr_torch.models.edsr_fast import make_fused_sr_apply
    from tpusr_torch.models.layers import pixel_shuffle
    from tpusr_torch.pipeline import PipelineServer, make_serving_pipeline
    from tpusr_torch.pipeline.http_serving import make_http_server

    try:
        dev = resolve_device(args.device)
    except RuntimeError:
        raise SystemExit(
            f"tpusr_torch serve: --device {args.device} asks for a CUDA card "
            f"and none is available; pass --device cpu to serve on the CPU "
            f"(the kernels' plain PyTorch twins)") from None
    lr_hw = (args.lr_size, args.lr_size)
    edsr = EDSRFacade(device=dev)
    edsr.setup_model(scale_factor=args.scale, from_pretrained=True,
                     pretrained_path=args.edsr_ckpt)
    vgg = FineTunedVGG16(device=dev)
    vgg.setup_model(input_shape=(args.patch, args.patch, 3),
                    num_classes=args.num_classes, from_pretrained=True,
                    pretrained_path=args.vgg16_ckpt)
    edsr_net, vgg_net = edsr.network(), vgg.network()

    calib_lr = calib_patches = None
    if args.sr_mode == "int8" or args.clf_mode.endswith("int8"):
        if args.calib_dir:
            calib = _read_calib_dir(args.calib_dir, lr_hw)
        else:
            print("warning: int8 mode without --calib-dir — calibrating on "
                  "random inputs (pass real LR images for tighter scales)",
                  flush=True)
            calib = np.random.default_rng(0).random(
                (8, *lr_hw), dtype=np.float32)[..., None].repeat(3, -1)
        calib_lr = torch.as_tensor(calib, device=dev)
        # classifier calibration patches come from the f32 SR of the same
        # calibration images: the distribution the classifier will see
        fn, r = make_fused_sr_apply(edsr_net)
        with torch.inference_mode():
            sr = pixel_shuffle(fn(calib_lr[:4]), r)
            pats = patchify(sr, args.patch, args.stride)
        calib_patches = pats.reshape((-1, args.patch, args.patch, 3))[:64]

    pipe = make_serving_pipeline(
        edsr_net, vgg_net, lr_hw, args.scale, patch=args.patch,
        stride=args.stride, sr_mode=args.sr_mode, clf_mode=args.clf_mode,
        calib_lr=calib_lr, calib_patches=calib_patches,
        sr_border_correction=not args.no_border,
        cascade_escalate_frac=args.cascade_frac,
        cascade_escalate_score=args.cascade_score,
        cascade_guard_threshold=(args.cascade_guard
                                 if args.cascade_guard > 0 else None),
        device=dev)

    config = {"sr_mode": args.sr_mode, "clf_mode": args.clf_mode,
              "scale": args.scale, "patch": args.patch,
              "stride": args.stride, "batch_size": args.batch_size,
              "max_wait_ms": args.max_wait_ms,
              "border_correction": not args.no_border, "device": str(dev)}
    if args.clf_mode == "cascade_int8":
        config["cascade_escalate_frac"] = args.cascade_frac
        config["cascade_escalate_score"] = args.cascade_score
        config["cascade_guard_threshold"] = (args.cascade_guard
                                             if args.cascade_guard > 0
                                             else None)
    note = _gate_certification_note(args)
    if note:
        config["gate"] = note
        print(f"tpusr_torch serve: {note}", flush=True)
    with PipelineServer(pipe, batch_size=args.batch_size,
                        max_wait_ms=args.max_wait_ms) as server:
        # warm the full serving path (the kernels' libraries load, cuDNN and
        # cuBLAS pick their algorithms, the worker's round trip) before the
        # port is announced: the first real request must not pay for it
        server.submit(np.zeros((*lr_hw, 3), np.float32)).result(timeout=900)
        httpd = make_http_server(
            server, lr_hw, config=config, host=args.host, port=args.port,
            request_timeout=args.request_timeout,
            max_requests=args.max_requests or None)
        port = httpd.server_address[1]
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(port))
        print(f"tpusr_torch serve: {args.sr_mode} SR x {args.clf_mode} on "
              f"{dev} at http://{args.host}:{port} (POST /classify, /sr, "
              f"/classify_sr; GET /healthz)", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()


def build_parser():
    p = argparse.ArgumentParser(prog="tpusr_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve", help="HTTP serving tier: micro-batched "
                        "SR + defect classification from trained checkpoints")
    sp.add_argument("--edsr-ckpt", required=True)
    sp.add_argument("--vgg16-ckpt", required=True)
    sp.add_argument("--scale", type=int, default=4)
    sp.add_argument("--lr-size", type=int, default=128,
                    help="served LR image side")
    sp.add_argument("--patch", type=int, default=96)
    sp.add_argument("--stride", type=int, default=48)
    sp.add_argument("--num-classes", type=int, default=2)
    # serve defaults = the JAX package's shipped mode: f32 SR +
    # vote_frac-ranked cascade_int8 at frac 0.25 with the trunk-collapse
    # guard at 0.6 (certified on the TPU by GATE_r05.json's 12 seeds; the
    # port's GATE_torch.json fails it on 1 of its 12 seeds, and the serve
    # command says so)
    sp.add_argument("--sr-mode", default="f32",
                    choices=("f32", "bf16", "int8"))
    sp.add_argument("--clf-mode", default="cascade_int8",
                    choices=("per_patch_f32", "per_patch_int8",
                             "shared_trunk_f32", "shared_trunk_int8",
                             "cascade_int8"))
    sp.add_argument("--cascade-score", choices=("conf", "vote_frac"),
                    default="vote_frac",
                    help="cascade_int8: escalation ranking signal — patch-"
                         "agreement fraction (certified) or trunk vote "
                         "confidence")
    sp.add_argument("--cascade-frac", type=float, default=0.25,
                    help="cascade_int8: fraction of each batch (the lowest-"
                         "scored trunk votes) escalated to the exact "
                         "per-patch int8 path")
    sp.add_argument("--cascade-guard", type=float, default=0.6,
                    help="cascade_int8: trunk-collapse guard threshold — "
                         "if the escalated subset's trunk-vs-per-patch "
                         "disagreement reaches it, the whole batch is "
                         "re-served per-patch (0 disables)")
    sp.add_argument("--no-border", action="store_true",
                    help="drop the int8 SR border band (classify-only mode: "
                         "fastest, SR output not image-faithful)")
    sp.add_argument("--calib-dir", default=None,
                    help="directory of LR PNG images for int8 calibration")
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--max-wait-ms", type=float, default=5.0)
    sp.add_argument("--request-timeout", type=float, default=120.0,
                    help="per-request wait on the batcher future (seconds)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8512,
                    help="0 picks a free port (printed + --port-file)")
    sp.add_argument("--port-file", default=None,
                    help="write the bound port here once listening")
    sp.add_argument("--max-requests", type=int, default=0,
                    help="shut down after N POSTs (0 = serve forever)")
    sp.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the kernels' plain PyTorch twins)")
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""float_torch command-line interface (twin of ``float_tpu.cli``).

    python -m float_torch.cli generate --image face.png --audio speech.wav \
        --checkpoint models/float/FLOAT.safetensors --output out.mp4
    python -m float_torch.cli inspect models/float/FLOAT.safetensors
    python -m float_torch.cli workflow configs/default.json
    python -m float_torch.cli graph example_workflows/graph_regular.json
    python -m float_torch.cli serve --checkpoint ... [--decode-batch 24] [--warm]
        [--mesh data=D,model=M]
    python -m float_torch.cli bench [--reps 10] [--stream]

Models run on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time


def _setup_logging(verbose: int):
    level = {0: logging.WARNING, 1: logging.INFO}.get(verbose, logging.DEBUG)
    logging.basicConfig(level=level,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")


def make_cli_progress(enabled: bool = True):
    """A ``progress(stage, i, n)`` callback rendering tqdm bars per stage
    when stderr is a tty, plain log lines otherwise."""
    if not enabled:
        return None
    state = {"bar": None, "stage": None}
    use_tqdm = sys.stderr.isatty()
    if use_tqdm:
        try:                     # tqdm is optional — plain log lines without
            from tqdm import tqdm  # noqa: F401
        except ImportError:
            use_tqdm = False

    def progress(stage, i, n):
        if not use_tqdm:
            if n > 1 or stage not in ("decode", "sample"):
                logging.getLogger("float_torch.cli").info(
                    "%s %d/%s", stage, i, n if n > 0 else "?")
            return
        from tqdm import tqdm
        if stage != state["stage"]:
            if state["bar"] is not None:
                state["bar"].close()
            state["bar"] = tqdm(total=(n if n > 0 else None), desc=stage,
                                leave=False, unit="step")
            state["stage"] = stage
        bar = state["bar"]
        bar.n = i
        bar.refresh()
        if n > 0 and i >= n and stage == "decode":
            bar.close()
            state["bar"] = None
            state["stage"] = None

    return progress


def _load_audio_file(path: str):
    import numpy as np
    from .audio.resample import read_wav_file, resample, to_mono
    if path.endswith(".npy"):
        audio_arr, sr = np.load(path), 16000
    else:
        audio_arr, sr = read_wav_file(path)
    return resample(to_mono(audio_arr), sr, 16000)


def cmd_generate(args):
    import numpy as np
    from .api.nodes import float_process
    from .image.transform import load_image_file
    from .io.video import write_video
    from .serve import load_pipe

    pipe = load_pipe(args.checkpoint, allow_synthetic=args.allow_synthetic,
                     advanced_float_options=(json.loads(args.adv_options)
                                             if args.adv_options else None),
                     device=args.device, decode_batch=args.decode_batch)
    img = load_image_file(args.image)
    mono = _load_audio_file(args.audio)
    progress = make_cli_progress(not args.no_progress)

    if args.stream:
        # streaming mode: frames are written (and the mp4 grows) while the
        # device still samples/decodes later chunks; first-frame latency
        # is printed separately from throughput
        import torch
        from .api.nodes import comfy_image_to_model_input, normalize_waveform
        cfg = pipe.cfg.replace(fps=args.fps)
        device = pipe.pipeline.device
        model_in, _ = comfy_image_to_model_input(
            img, cfg.input_size, cfg.rgba_conversion, cfg.bkg_color_hex,
            face_align=args.face_align, face_margin=cfg.face_margin)
        model_in = torch.as_tensor(model_in, device=device)
        wave_n = torch.as_tensor(normalize_waveform(mono, pipe.fe)[None],
                                 device=device)
        t0 = time.perf_counter()
        first = [None]

        def chunks():
            total = 0
            for start, frames in pipe.pipeline.generate_stream(
                    model_in, wave_n, emotion=args.emotion,
                    seed=args.seed, a_cfg_scale=args.a_cfg_scale,
                    e_cfg_scale=args.e_cfg_scale, fps=args.fps,
                    progress=progress):
                if first[0] is None:
                    first[0] = time.perf_counter() - t0
                total += frames.shape[0]
                yield frames
            chunks.total = total

        if args.output.endswith(".npy"):
            all_chunks = list(chunks())
            frames_cat = np.concatenate(all_chunks, axis=0)
            np.save(args.output, frames_cat)
            n_frames = frames_cat.shape[0]
        else:
            write_video(args.output, chunks(), args.fps,
                        audio=mono, sample_rate=16000)
            n_frames = chunks.total
        dt = time.perf_counter() - t0
        print(f"generated {n_frames} frames in {dt:.2f}s "
              f"({n_frames/dt:.1f} fps); first frames after {first[0]:.2f}s")
    else:
        t0 = time.perf_counter()
        frames, _, fps = float_process(
            img[None], mono[None], pipe,
            a_cfg_scale=args.a_cfg_scale, e_cfg_scale=args.e_cfg_scale,
            fps=args.fps, emotion=args.emotion, face_align=args.face_align,
            seed=args.seed, progress=progress)
        dt = time.perf_counter() - t0
        print(f"generated {frames.shape[0]} frames in {dt:.2f}s "
              f"({frames.shape[0]/dt:.1f} fps)")
        if args.output.endswith(".npy"):
            np.save(args.output, frames)
        else:
            write_video(args.output, frames, args.fps,
                        audio=mono, sample_rate=16000)
    print(f"wrote {args.output}")


def cmd_inspect(args):
    from .io.checkpoint import (load_safetensors, split_unified,
                                infer_encoder_arch, infer_synthesis_arch,
                                infer_fmt_arch, infer_projection_arch)
    flat = load_safetensors(args.checkpoint)
    total = sum(v.size for v in flat.values())
    print(f"{args.checkpoint}: {len(flat)} tensors, {total/1e6:.1f} M params")
    parts = split_unified(flat)
    for name, part in parts.items():
        if not part:
            continue
        n = sum(v.size for v in part.values())
        print(f"  {name}: {len(part)} tensors, {n/1e6:.1f} M params")
    try:
        if parts["encoder"]:
            print("  encoder arch:", infer_encoder_arch(parts["encoder"]))
        if parts["synthesis"]:
            print("  synthesis arch:", infer_synthesis_arch(parts["synthesis"]))
        if parts["fmt"]:
            print("  fmt arch:", infer_fmt_arch(parts["fmt"]))
        if parts["audio_projection"]:
            print("  projection arch:",
                  infer_projection_arch(parts["audio_projection"]))
    except Exception as exc:
        print("  (arch inference failed:", exc, ")")


def cmd_bench(args):
    """``float_torch.bench`` in this process (config 1 on the card; exit
    1 without one)."""
    from . import bench
    argv = ["--reps", str(args.reps)] + (["--stream"] if args.stream else [])
    raise SystemExit(bench.main(argv))


def cmd_workflow(args):
    """Run a JSON workflow config (the 5 BASELINE configs are expressible)."""
    from .runtime.workflow import run_workflow
    with open(args.config) as f:
        wf = json.load(f)
    run_workflow(wf, output=args.output,
                 progress=make_cli_progress(), device=args.device)


def _parse_set_overrides(pairs):
    """--set NODE.PARAM=VALUE -> {selector: {param: value}}; VALUE is
    parsed as JSON when possible (numbers/bools), else kept as string."""
    out = {}
    for spec in pairs or []:
        try:
            target, value = spec.split("=", 1)
            selector, param = target.rsplit(".", 1)
        except ValueError:
            raise SystemExit(f"--set expects NODE.PARAM=VALUE, got {spec!r}")
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass
        out.setdefault(selector, {})[param] = value
    return out


def cmd_graph(args):
    """Execute a ComfyUI workflow graph JSON (the reference's own
    example_workflows files run unchanged)."""
    from .api.comfy import run_comfy_workflow, GraphContext
    overrides = _parse_set_overrides(args.set)
    if args.image:
        overrides.setdefault("LoadImage", {})["image"] = args.image
        overrides.setdefault("SET_ImageDownload", {})["filename"] = args.image
    if args.audio:
        overrides.setdefault("LoadAudio", {})["audio"] = args.audio
        overrides.setdefault("SET_AudioDownload", {})["filename"] = args.audio
    ctx = GraphContext(device=args.device, models_root=args.models_root,
                       inputs_dir=args.inputs_dir,
                       output_dir=args.output_dir,
                       overrides=overrides,
                       allow_synthetic=args.allow_synthetic,
                       progress=make_cli_progress(not args.no_progress))
    _results, ctx = run_comfy_workflow(args.workflow, ctx)
    for path in ctx.artifacts:
        print(f"wrote {path}")
    if not ctx.artifacts:
        print("graph executed (no output nodes — add VHS_VideoCombine or "
              "PreviewImage to write files)")


def cmd_serve(args):
    from .serve import serve
    serve(args.checkpoint, host=args.host, port=args.port,
          allow_synthetic=args.allow_synthetic,
          models_root=args.models_root,
          advanced_float_options=(json.loads(args.adv_options)
                                  if args.adv_options else None),
          mesh_spec=args.mesh, warm=args.warm, device=args.device,
          decode_batch=args.decode_batch)


def _device_arg(parser):
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the models run (default: the CUDA card)")


def _decode_batch_arg(parser):
    parser.add_argument("--decode-batch", type=int, metavar="N",
                        help="frames per synthesis decode chunk (default: "
                             "the config's 8; more frames per chunk, fewer "
                             "kernel launches per clip)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="float_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-v", "--verbose", action="count", default=0)
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="image + audio -> talking-head video")
    g.add_argument("--image", required=True)
    g.add_argument("--audio", required=True)
    g.add_argument("--output", default="out.mp4")
    g.add_argument("--checkpoint", default="models/float/FLOAT.safetensors")
    g.add_argument("--a-cfg-scale", type=float, default=2.0)
    g.add_argument("--e-cfg-scale", type=float, default=1.0)
    g.add_argument("--fps", type=float, default=25.0)
    g.add_argument("--emotion", default="none")
    g.add_argument("--face-align", nargs="?", const=True, default=False,
                   choices=[True, False, "fallback"],
                   type=lambda v: {"true": True, "false": False}.get(v, v),
                   help="detect+crop the face; 'fallback' allows a "
                        "center-crop when face_alignment is missing")
    g.add_argument("--seed", type=int, default=15)
    g.add_argument("--adv-options", help="JSON ADV_FLOAT_DICT overrides")
    g.add_argument("--allow-synthetic", action="store_true",
                   help="run with random weights when the checkpoint is "
                        "missing (testing only)")
    g.add_argument("--stream", action="store_true",
                   help="write frames as they decode (low first-frame "
                        "latency; the mp4 grows during generation)")
    g.add_argument("--no-progress", action="store_true",
                   help="disable the progress bars / progress log lines")
    _device_arg(g)
    _decode_batch_arg(g)
    g.set_defaults(func=cmd_generate)

    i = sub.add_parser("inspect", help="show checkpoint structure + arch")
    i.add_argument("checkpoint")
    i.set_defaults(func=cmd_inspect)

    b = sub.add_parser("bench", help="config 1's frames/s (or, with "
                                     "--stream, its time to the first "
                                     "chunk) on the card: one JSON line")
    b.add_argument("--reps", type=int, default=10)
    b.add_argument("--stream", action="store_true")
    b.set_defaults(func=cmd_bench)

    w = sub.add_parser("workflow", help="run a JSON workflow config")
    w.add_argument("config")
    w.add_argument("--output", default="out")
    _device_arg(w)
    w.set_defaults(func=cmd_workflow)

    gr = sub.add_parser("graph",
                        help="execute a ComfyUI workflow graph JSON")
    gr.add_argument("workflow", help="ComfyUI-format workflow .json")
    gr.add_argument("--models-root", default="models")
    gr.add_argument("--inputs-dir", default=".",
                    help="directory LoadImage/LoadAudio filenames resolve in")
    gr.add_argument("--output-dir", default=".")
    gr.add_argument("--image", help="override every LoadImage file")
    gr.add_argument("--audio", help="override every LoadAudio file")
    gr.add_argument("--set", action="append", metavar="NODE.PARAM=VALUE",
                    help="override a node input (NODE = type, title, or "
                         "flattened key; repeatable)")
    gr.add_argument("--allow-synthetic", action="store_true")
    gr.add_argument("--no-progress", action="store_true")
    _device_arg(gr)
    gr.set_defaults(func=cmd_graph)

    s = sub.add_parser("serve", help="HTTP serving daemon (health / "
                                     "generate / stream / graph endpoints)")
    s.add_argument("--checkpoint", default="models/float/FLOAT.safetensors")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8472)
    s.add_argument("--models-root", default="models")
    s.add_argument("--adv-options", help="JSON ADV_FLOAT_DICT overrides")
    s.add_argument("--allow-synthetic", action="store_true")
    s.add_argument("--mesh", metavar="data=D,model=M",
                   help="serve over every card as a (data, model) mesh: "
                        "clips split over data, the FMT and wav2vec2 "
                        "over model, each decode chunk's frames over all")
    s.add_argument("--warm", action="store_true",
                   help="run the serving paths once BEFORE binding the "
                        "port (kernel builds, cuDNN's algorithm choice), "
                        "so the first request never pays for them")
    _device_arg(s)
    _decode_batch_arg(s)
    s.set_defaults(func=cmd_serve)

    args = ap.parse_args(argv)
    _setup_logging(args.verbose)
    args.func(args)


if __name__ == "__main__":
    main()

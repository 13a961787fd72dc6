"""Headless CLI of the port (counterpart of ``tracer.cli``): the reference's
control panel (``reference/src/control_panel.rs``) as flags.

Every flag of ``tracer.cli`` with the same meaning, plus ``--device``: the
render runs on the card (``tracer_torch.util.self_test`` probes it first
and stops with one sentence when there is none) unless ``--device cpu``
asks for the CPU. ``--traversal bvh2`` and ``bvh8`` run the per-ray BVH
walks, and ``--traversal bsp`` the BSP rows' default execution (the
treelet engines), as in the JAX package.

``--sharded`` renders over a ``torch.distributed`` group
(``tracer_torch.parallel``): under ``torchrun`` (one rank per card, each on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``) each rank renders its band
of pixel rows, ``--resume`` hands each rank its band of the checkpoint, and
the first rank writes ``--out``/``--out-pfm``/``--out-npz`` and the
checkpoints (the same ``.npz`` layout). Without ``torchrun``'s variables the
flag runs a group of one rank on the chosen device. The image equals the
unsharded one bit for bit.

Usage:
  python -m tracer_torch.cli --list
  python -m tracer_torch.cli --scene "Project: Dragon" --samples 8 --out d.png --out-npz d.npz
  python -m tracer_torch.cli --device cpu --scene "W1 E6" --width 64 --height 64 --out w.png
  torchrun --nproc-per-node 4 -m tracer_torch.cli --sharded --scene "Project: Dragon" --out d.png
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import torch

from tracer_torch import obs

REFUSED = 2  # exit code of a configuration the port does not serve


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--list", action="store_true", help="list scenes and exit")
    p.add_argument("--scene", default="W1 E6", help="scene name")
    p.add_argument("--width", type=int, default=0, help="override width")
    p.add_argument("--height", type=int, default=0, help="override height")
    p.add_argument("--samples", type=int, default=1, help="progressive samples")
    p.add_argument("--camera-constant", type=float, default=0.0,
                   help="override camera focal constant (0.1-10 in the UI)")
    p.add_argument("--sphere-material", type=int, default=-1,
                   help="selection1 shader id (0=lambertian..6=basecolor)")
    p.add_argument("--other-material", type=int, default=-1, help="selection2 shader id")
    p.add_argument("--subdivision", type=int, default=0,
                   help="pixel subdivision level 1-10 (stratified AA)")
    p.add_argument("--texture-mode", type=int, default=-1,
                   help="0 none, 1 default, 2 bilinear, 3 nearest")
    p.add_argument("--uv-scale", type=float, nargs=2, default=None)
    p.add_argument("--traversal", choices=["brute", "bvh", "bvh2", "bvh8", "bsp"], default=None)
    p.add_argument("--camera-moves", default=None, metavar="KEYS",
                   help="WASD move string applied before rendering, one tick per "
                   "char (the reference's orbit/dolly controller, camera.rs:36-112)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render to DIR/trace.json, "
                        "with the port's layers as tracer_torch:<layer> spans")
    p.add_argument("--interactive", action="store_true",
                   help="REPL mode: re-render on parameter commands (the reference's "
                   "live command loop, lib.rs:365-488)")
    p.add_argument("--out", default=None, help="output PNG path")
    p.add_argument("--out-pfm", default=None, help="output PFM (linear float)")
    p.add_argument("--out-npz", default=None, help="output NPZ (linear float)")
    p.add_argument("--checkpoint", default=None, help="checkpoint path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--sharded", action="store_true",
                   help="render bands of rows over the torch.distributed group (torchrun's "
                   "ranks; one rank without torchrun)")
    p.add_argument("--stats-every", type=float, default=5.0,
                   help="seconds between render-stat prints (0 = off)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' only when asked)")
    return p


def _log(msg: str) -> None:
    print(f"[cli] {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def interactive_loop(scene, cfg, args, dev) -> int:
    """Live render loop: read commands from stdin, replace the scene's
    camera or uniforms, re-render. Commands (as ``tracer.cli``):

      c <constant>        camera focal constant (0.1-10)
      m1 <id> / m2 <id>   sphere / other material selection (0-8)
      move <wasd...>      camera controller ticks (camera.rs:36-112)
      uv <su> <sv>        texture uv scale
      tex <mode>          sampler mode 0-3
      r [n]               render n more progressive samples (default
                          --samples); state accumulates
      reset               clear the accumulator
      save <path.png>     write current image
      q                   quit
    """
    from tracer_torch import io as tio
    from tracer_torch.render import progressive as P
    from tracer_torch.render.controller import CameraController

    state = P.init_state(cfg, dev)

    def render(n_more):
        t0 = time.perf_counter()
        for _ in range(n_more):
            P.step(scene, cfg, state)
        _sync(dev)
        dt = time.perf_counter() - t0
        _log(f"{n_more} sample(s) in {dt:.3f}s ({dt / max(n_more, 1) * 1e3:.1f} ms/frame), "
             f"iteration={state.iteration}")

    def restart(**parts):
        nonlocal scene, state
        scene = dataclasses.replace(scene, **parts)
        state = P.init_state(cfg, dev)
        render(args.samples)

    def uniforms(**kw):
        return dict(uniforms=dataclasses.replace(scene.uniforms, **kw))

    render(args.samples)
    _log("interactive: c/m1/m2/move/uv/tex/r/reset/save/q")
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        cmd, rest = parts[0], parts[1:]
        try:
            if cmd == "q":
                break
            elif cmd == "c":
                cam = scene.camera
                restart(camera=dataclasses.replace(cam, constant=torch.full_like(
                    cam.constant, float(rest[0]))))
            elif cmd in ("m1", "m2"):
                field = "selection1" if cmd == "m1" else "selection2"
                restart(**uniforms(**{field: int(rest[0])}))
            elif cmd == "move":
                restart(camera=CameraController().run(scene.camera, rest[0]))
            elif cmd == "uv":
                restart(**uniforms(uv_scale=torch.tensor(
                    (float(rest[0]), float(rest[1])), device=dev)))
            elif cmd == "tex":
                restart(**uniforms(use_texture=int(rest[0])))
            elif cmd == "r":
                render(int(rest[0]) if rest else args.samples)
            elif cmd == "reset":
                state = P.init_state(cfg, dev)
                _log("accumulator cleared")
            elif cmd == "save":
                tio.write_png(rest[0], P.image(state, cfg))
                _log(f"wrote {rest[0]}")
            else:
                _log(f"unknown command: {cmd}")
        except (ValueError, IndexError) as e:
            _log(f"bad command {line.strip()!r}: {e}")
    if args.out:
        tio.write_png(args.out, P.image(state, cfg))
        _log(f"wrote {args.out}")
    return 0


@contextlib.contextmanager
def _profiled(out_dir: str, dev: torch.device):
    """A ``torch.profiler`` trace of the body (host ops, the port's layer
    spans ``tracer_torch:<layer>``, and the card's kernels when rendering
    on it), written to ``out_dir/trace.json`` even if the body raises."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=acts)
    was = obs.SPANS
    obs.enabled(True)
    try:
        with prof:
            yield
    finally:
        obs.enabled(was)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def _descriptor(args):
    """The registry row of ``--scene`` with the flags' overrides."""
    from tracer_torch.scenes.registry import get_scene

    desc = get_scene(args.scene)
    cfg_kw = {}
    if args.width:
        cfg_kw["width"] = args.width
    if args.height:
        cfg_kw["height"] = args.height
    if args.traversal:
        cfg_kw["traversal"] = args.traversal
    if args.subdivision:
        cfg_kw["subdivs"] = args.subdivision
    if cfg_kw:
        desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, **cfg_kw))
    if args.sphere_material >= 0:
        desc = dataclasses.replace(desc, selection1=args.sphere_material)
    if args.other_material >= 0:
        desc = dataclasses.replace(desc, selection2=args.other_material)
    if args.camera_constant:
        desc = dataclasses.replace(desc, camera=dict(desc.camera, constant=args.camera_constant))
    return desc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from tracer_torch.scenes.registry import get_scenes

    if args.list:
        for d in get_scenes():
            model = d.model.rsplit("/", 1)[-1] if d.model else "-"
            print(f"{d.name:28s} {d.cfg.width}x{d.cfg.height} "
                  f"{d.cfg.mode:6s} {d.cfg.traversal:5s} {model}")
        return 0

    from tracer_torch.scenes.build import scene_config
    from tracer_torch.util import BackendError, self_test

    desc = _descriptor(args)
    try:
        scene_config(desc)
    except NotImplementedError as e:
        _log(str(e))
        return REFUSED
    created = False
    if args.sharded and not args.interactive:
        import torch.distributed as dist

        from tracer_torch.parallel import distributed

        dev = distributed.local_device(args.device or "cuda")
        if dev.type == "cuda":
            try:
                dev, probe = self_test(str(dev))
            except BackendError as e:
                _log(str(e))
                return 1
            _log(f"device {probe}")
        created = not dist.is_initialized()
        distributed.initialize_from_env(dev, one_rank=True)
    elif args.device is not None and torch.device(args.device).type != "cuda":
        dev = torch.device(args.device)
    else:
        try:
            dev, probe = self_test(args.device)
        except BackendError as e:
            _log(str(e))
            return 1
        _log(f"device {probe}")
    try:
        return _render(args, desc, dev)
    finally:
        if created:
            dist.destroy_process_group()


def _render(args, desc, dev) -> int:
    """Build the scene and render it as the flags say (one process, or this
    rank's band with ``--sharded``)."""
    from tracer_torch import io as tio
    from tracer_torch.render import progressive as P
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.tools import RenderStats

    mesh = None
    if args.sharded and not args.interactive:
        from tracer_torch.parallel import distributed, shard

        mesh = shard.make_ray_mesh()
        _log(f"rank {mesh.rank} of {mesh.size} ({distributed.backend_for(dev)})")
    timings: dict = {}
    scene, cfg = build_scene(desc, dev, timings=timings)
    _log(f"scene '{desc.name}' built in {timings['total']:.2f}s ("
         + ", ".join(f"{k}={v:.3f}s" for k, v in timings.items() if k != "total") + ")")

    if args.camera_moves:
        from tracer_torch.render.controller import CameraController

        scene = dataclasses.replace(
            scene, camera=CameraController().run(scene.camera, args.camera_moves))
    u = scene.uniforms
    if args.texture_mode >= 0:
        u = dataclasses.replace(u, use_texture=args.texture_mode)
    if args.uv_scale:
        u = dataclasses.replace(u, uv_scale=torch.tensor(args.uv_scale, device=dev))
    scene = dataclasses.replace(scene, uniforms=u)

    state = None
    if args.resume and args.checkpoint:
        state = P.load_checkpoint(args.checkpoint, cfg, dev)
        _log(f"resumed at iteration {state.iteration}")

    if args.interactive:
        ignored = [name for name, on in (("--sharded", args.sharded),
                                         ("--profile", bool(args.profile)),
                                         ("--checkpoint", bool(args.checkpoint)),
                                         ("--checkpoint-every", args.checkpoint_every > 0))
                   if on]
        if ignored:
            _log(f"warning: --interactive ignores {', '.join(ignored)} "
                 "(the REPL drives its own loop)")
        return interactive_loop(scene, cfg, args, dev)

    prof_ctx = _profiled(args.profile, dev) if args.profile else contextlib.nullcontext()
    if args.profile:
        _log(f"profiling to {args.profile}")
    stats = RenderStats(print_every=args.stats_every)
    st = state or P.init_state(cfg, dev)
    step, whole = P.step, lambda s: s
    if mesh is not None:
        scene = shard.replicate_scene(scene, mesh)
        st = shard.shard_state(st, cfg, mesh)
        step = shard.sharded_step(mesh)
        whole = lambda s: shard.gather_state(s, cfg, mesh)
    writer = mesh is None or mesh.rank == 0

    def checkpoint(s):
        s = whole(s)  # every rank joins the gather
        if writer:
            P.save_checkpoint(args.checkpoint, s, cfg)

    with prof_ctx:
        for i in range(st.iteration, args.samples):
            stats.begin()
            step(scene, cfg, st)
            _sync(dev)
            stats.end()
            if args.checkpoint and args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
                checkpoint(st)
    _log(f"rendered {st.iteration} samples; {stats.summary()}")
    if args.checkpoint:
        checkpoint(st)
    st = whole(st)
    if not writer:
        return 0
    lin = st.accum.cpu().numpy().reshape(cfg.height, cfg.width, 3)
    if args.out:
        tio.write_png(args.out, P.image(st, cfg))
        _log(f"wrote {args.out}")
    if args.out_pfm:
        tio.write_pfm(args.out_pfm, lin)
    if args.out_npz:
        tio.write_npz(args.out_npz, lin, iteration=st.iteration)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The frame loop: ``tracer_torch.render.progressive.step`` in a closed
loop from ``progressive.init_state``, one ``torch.cuda.synchronize()`` a
frame, because the viewer shows every frame. What it hands the check is
the progressive accumulator at the checked pixels, and the frame counter
against the frames the window completed (``frames_missing``, exact)."""

from benchmark import inputs as inp

UNIT = "frame"


def prepare(c, inputs: dict, scene, cfg, device, sync):
    """(one frame, ``output(seed, frames)``), after one warm-up frame on a
    state of its own."""
    from tracer_torch.render import progressive

    warm = progressive.init_state(cfg, device)
    warm.iteration = inputs["start"]
    progressive.step(scene, cfg, warm)
    del warm
    state = progressive.init_state(cfg, device)
    state.iteration = inputs["start"]

    def unit_fn():
        progressive.step(scene, cfg, state)
        sync(device)

    def output(seed: int, frames: int):
        pix = inp.checked_pixels(c.config, c.traffic["check"], seed, frames, state.accum.device)
        missing = state.iteration - (inputs["start"] + frames)
        return state.accum[pix].detach().clone(), {"frames_missing": float(abs(missing))}

    return unit_fn, output

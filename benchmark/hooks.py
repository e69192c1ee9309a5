"""What the traced run counts, from wrappers the benchmark puts around
public entries of the program and of PyTorch; nothing of the program is
edited.

- ``inside``: wall seconds of every ``solver.solve`` and
  ``parallel.batch.solve_batch_fields`` call (the pattern of the
  program's ``northstar.timed_solves``): what of a step is spent inside
  the solver, hierarchies and copies included.
- ``replays`` and ``captures``: calls of ``torch.cuda.CUDAGraph.replay``
  and ``capture_begin``.
- ``line_launches``: the shape of every ``line_phase`` launch that ran
  while ``recording`` is on: those through ``ops.line_phase.LinePlan``
  one by one, and, for each replay of a graph, the launches that went
  through the wrapper while that graph was captured (a replay does not
  call the wrapper).

:class:`StackSampler` reads, from a thread of its own, what the main
thread is running in the program: the traced span's idle time is split
by it (:mod:`benchmark.devtrace`).
"""

import pathlib
import sys
import threading
import time

import torch


class Tracer:
    def __init__(self):
        self.inside = []
        self.replays = 0
        self.captures = 0
        self.line_launches = []
        self.recording = False
        self._capturing = None
        self._saved = []

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def install(self):
        from emg3d_tpu_torch import solver
        from emg3d_tpu_torch.ops import line_phase
        from emg3d_tpu_torch.parallel import batch

        tracer = self

        def timed(orig):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return orig(*args, **kwargs)
                finally:
                    tracer.inside.append(time.perf_counter() - t0)
            return call

        def capture_begin(orig):
            def call(graph, *args, **kwargs):
                tracer.captures += 1
                graph._benchmark_line = []
                tracer._capturing = graph
                return orig(graph, *args, **kwargs)
            return call

        def capture_end(orig):
            def call(graph, *args, **kwargs):
                tracer._capturing = None
                return orig(graph, *args, **kwargs)
            return call

        def replay(orig):
            def call(graph, *args, **kwargs):
                tracer.replays += 1
                if tracer.recording:
                    tracer.line_launches.extend(
                        getattr(graph, "_benchmark_line", ()))
                return orig(graph, *args, **kwargs)
            return call

        def plan_init(orig):
            def call(plan, ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                     hx, hy, hz, axis, scale=None):
                orig(plan, ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z,
                     zeta, hx, hy, hz, axis, scale)
                plan._benchmark_shape = (
                    tuple(zeta.shape[-3:]), axis,
                    ex.shape[0] if ex.dim() == 4 else 1,
                    eta_x.dim() == 4, ex.element_size(),
                    zeta.element_size())
            return call

        def plan_launch(orig):
            def call(plan, p1, p2):
                before = line_phase.LAUNCHES
                orig(plan, p1, p2)
                if line_phase.LAUNCHES == before:
                    return          # an empty phase launches nothing
                launch = (plan._benchmark_shape, (p1, p2))
                if tracer._capturing is not None:
                    tracer._capturing._benchmark_line.append(launch)
                elif tracer.recording:
                    tracer.line_launches.append(launch)
            return call

        self._patch(solver, "solve", timed)
        self._patch(batch, "solve_batch_fields", timed)
        self._patch(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
        self._patch(torch.cuda.CUDAGraph, "capture_end", capture_end)
        self._patch(torch.cuda.CUDAGraph, "replay", replay)
        self._patch(line_phase.LinePlan, "__init__", plan_init)
        self._patch(line_phase.LinePlan, "launch", plan_launch)

    def uninstall(self):
        while self._saved:
            owner, name, orig = self._saved.pop()
            setattr(owner, name, orig)


class StackSampler:
    """Every ``period`` seconds, the innermost function of the program
    (``module.function`` inside ``emg3d_tpu_torch``) on the thread that
    made the sampler, with its ``time.perf_counter()``; "outside the
    program" where the stack holds none.  The main thread hands the
    interpreter lock over every few milliseconds, so samples come about
    that often while it runs Python."""

    def __init__(self, period=0.002):
        import emg3d_tpu_torch
        self.root = str(pathlib.Path(emg3d_tpu_torch.__file__).parent)
        self.period = period
        self.samples = []
        self._thread_id = threading.get_ident()
        self._stop = threading.Event()
        self._thread = None

    def _label(self, frame):
        while frame is not None:
            path = frame.f_code.co_filename
            if path.startswith(self.root):
                module = path[len(self.root) + 1:-3].replace("/", ".")
                return f"{module}.{frame.f_code.co_name}"
            frame = frame.f_back
        return "outside the program"

    def _run(self):
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self._thread_id)
            self.samples.append((time.perf_counter(), self._label(frame)))

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

"""One window loop per kind of entry of the port: ``serve`` (make_predict_fn
on host frames) and ``train`` (make_train_step fed by the Prefetcher).

``run(torch, wl, cfg, seed, seconds, trace, dev, spans, hooks)`` sets up
and warms the cell's shapes, measures a closed loop for ``seconds``, takes
the traced stretch when ``trace``, reads the peak memory, frees the
program and judges what the window produced against the reference. It
returns the run's record, which the metric readers take their numbers
from. ``hooks`` swap parts of the timed path; only the checks of the
benchmark itself pass them (the control and the planted faults).
"""

"""Traffic mode ``serial``: one image at a time through
``automation.process_image`` in one thread, closed loop."""

import time


def drive(run, cfg, warm, window, out):
    import superdsm_tpu_torch as port
    run.barrier = None
    pipeline = run.spans.attach(port.create_default_pipeline())
    for item in warm:
        run.run_image(pipeline, cfg, item, out)
    run.window_started()
    for item in window:
        if time.perf_counter() >= run.deadline:
            break
        run.run_image(pipeline, cfg, item, out)
    run.window_closed()

"""Traffic mode ``pipelined``: images handed to the traffic mix's
``threads`` worker threads of ``process_images_pipelined``, each on its own
CUDA stream, closed loop."""

import threading


def drive(run, cfg, warm, window, out):
    import superdsm_tpu_torch as port
    from superdsm_tpu_torch.output import get_output
    from superdsm_tpu_torch.parallel.pipelined import process_images_pipelined
    threads = run.traffic['threads']
    # every worker thread takes its warm-up images, then all wait here and
    # the window starts: the window's threads are warm
    run.barrier = threading.Barrier(threads, action=run.window_started)

    def factory():
        return run.spans.attach(port.create_default_pipeline())

    def process_image(pipeline, c, item, out=None):
        return run.run_image(pipeline, c, item, out or get_output(None))

    process_images_pipelined(factory, cfg, warm + window, threads=threads,
                             process_image=process_image, out=out)
    run.window_closed()

"""Warm-started DSM lanes solved per finished window image: the problems
of the window images' solves that start from a parent's solution
(``init_params`` set), which the global energy minimization's generations
hand to the solver after the bounds have pruned, over the window images
that finished. Read from the benchmark's solve probe (``run.recorder``)."""


def read(run):
    done = {i for i, r in run.records.items() if r.get('error') is None}
    solves = [s for s in run.recorder.solves if s['image'] in done]
    if not done or not solves:
        return None
    lanes = sum(1 for s in solves for p in s['problems']
                if getattr(p, 'init_params', None) is not None)
    return lanes / len(done)

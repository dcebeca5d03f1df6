"""Host milliseconds an epoch in which the card waits on the training
loop between two replays: from the end of one block's synchronize (the
program's span ``train.wait``; the card is idle from there) to the start
of the next block's work: its graph launch (``graph.launch``), or its
first ``epoch`` where the block runs its epochs eagerly; over the traced
epochs, per epoch.  It holds the loggers, the loop, and the replay's
work before its launch; the launch itself, during which the card starts
on the graph, is left out.

The program (cgs_vmc_tpu_torch/utils/profiling.py) records these host
spans while a profiler runs, so the traced epochs are the last it
recorded.  None where the program has no spans, or recorded too few."""

import importlib


def read(run):
    if run.kind != 'train' or run.trace is None or run.trace.units < 2:
        return None
    try:
        profiling = importlib.import_module(
            'cgs_vmc_tpu_torch.utils.profiling')
    except ImportError:
        return None
    report = getattr(profiling, 'span_report', None)
    if report is None:
        return None
    report = report()
    rows = report['epochs'][-run.trace.units:]
    if len(rows) < run.trace.units:
        return None
    first, last = rows[0]['epoch'], rows[-1]['epoch']
    waits, launches = {}, {}
    for s in report['spans']:     # oldest first: the last run's overwrite
        if s['epoch'] is not None and first <= s['epoch'] <= last:
            if s['name'] == 'train.wait':
                waits[s['epoch']] = s['end_ns']
            elif (s['name'] in ('graph.launch', 'epoch')
                  and s['start_ns'] is not None):
                launches[s['epoch']] = s['start_ns']
    blocks = sorted(waits)
    if len(blocks) < 2 or any(b not in launches for b in blocks[1:]):
        return None
    turns = sum(launches[b] - waits[a] for a, b in zip(blocks, blocks[1:]))
    return turns / 1e6 / (blocks[-1] - blocks[0])

"""Host syncs an iteration of the training loop (``Trainer.train`` and the
step's host reads), counted under ``torch.cuda.set_sync_debug_mode("warn")``
over one whole drain chunk outside the profiled segment."""


def read(t: dict):
    if not t["sync_iterations"]:
        return None
    return t["syncs"] / t["sync_iterations"]

"""prepare_ms.train: the host time of the program's
`p3d.trainer.prepare_batch` span (`UNetTrainer._prepare_batch`: the batch's
pageable upload, and device augmentation where it is on) per update of the
traced window, in ms (spans.py `host_ms`). Leaves out the loader's own time.
Moves the train cell's rate, train_vox_s."""

from benchmark.spans import host_ms


def read(window):
    return host_ms(window, "p3d.trainer.prepare_batch") if window.kind == "train" else None

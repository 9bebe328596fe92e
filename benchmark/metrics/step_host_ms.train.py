"""step_host_ms.train: the host time of the program's `p3d.trainer.step`
spans (the train step's call in `UNetTrainer._update`: forward, loss,
backward and the optimizer's step; with accumulation every microbatch's call
and the apply) per update of the traced window, in ms (spans.py `host_ms`).

What the host does there is launch the step's device work: no call inside
the step synchronizes with the device, and the host waits for it only at the
loss's read-back after the span, or inside it when the device has fallen so
far behind that the launch queue is full. The profiler of the traced run
records every operation and launch, so the host's time here is that of a
traced host, longer than an untraced one's. Moves the train cell's rate,
train_vox_s, once the step's launches take as long as its device work."""

from benchmark.spans import host_ms


def read(window):
    return host_ms(window, "p3d.trainer.step") if window.kind == "train" else None

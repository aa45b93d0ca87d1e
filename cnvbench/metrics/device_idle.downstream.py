"""``device_idle.infercnv``'s reading under the chain's name: 1 - device busy / wall over the traced calls, the
mean over the run's devices; the same reader, loaded from its file beside this one."""

from pathlib import Path

from cnvbench import spec

read = spec._load(Path(__file__).with_name("device_idle.infercnv.py"), "metric.device_idle.infercnv").read

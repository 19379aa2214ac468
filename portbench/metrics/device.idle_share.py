"""The device's idle share in the replays: traced busy over the untraced window's replay clock.

Reader: ``readers.idle_share``.
"""

from portbench import readers

NAME, UNIT, BETTER, SOURCE = "device.idle_share", "%", "lower", "device_trace"
LAYER = "device"
MOVES, WORKLOADS = "lane_steps_per_s", None
read = readers.idle_share

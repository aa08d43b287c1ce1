"""Device milliseconds a hop of the model's convolutions (``models/``, through
``F.conv2d``: cuDNN), the device time of the kernels every
``aten::convolution`` op of the slice launched, from the session that traces
the host's ops (device times are the card's own, whatever the host's cost)."""


def read(sl):
    us = sl.host_device_us("aten::convolution")
    return us / 1e3 / sl.calls if us else None

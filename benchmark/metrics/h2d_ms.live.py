"""Device milliseconds a hop of copies from the host (the hop's upload,
``_HopEngine._as_audio``), summed over the slice's host-to-device copies."""


def read(sl):
    us = sl.device_us(lambda name: "Memcpy HtoD" in name)
    return us / 1e3 / sl.calls if us else None

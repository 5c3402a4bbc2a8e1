"""device_idle_share.{batch,request}: the share of the traced window in
which no kernel, copy or fill ran on the device, %. It rises where the
host holds the card back (the step loop's enqueue, the model's metadata
work per XOR, the readback)."""


def read(view, entry):
    if view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)

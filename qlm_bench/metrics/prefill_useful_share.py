"""The share, in percent, of the rows the chunk rounds compute (the
``max_slots x bucket`` rows of each ``prefill_chunk_paged`` call) that
advance a prompt, over the traced slice."""


def read(run, qualifier=None):
    led = run.ledger
    if led is None or not led.computed_rows:
        return None
    return 100.0 * led.useful_rows / led.computed_rows

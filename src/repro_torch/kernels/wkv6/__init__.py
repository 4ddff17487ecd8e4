"""RWKV-6 WKV recurrence kernel, forward and backward (see ``ops``)."""

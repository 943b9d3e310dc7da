"""Network runtime of the port: the ddcd DDC server (ddcd.py, every
client's channel a row of one batched device step) and the launcher of the
native nmux fan-out binary (nmux.py, native/)."""

"""The byte floor of each pipeline that ``fhebench/work.py`` does not count
itself: ``<system>.py`` holds ``floor_bytes(config, encoded_inputs) -> int``,
the least bytes one request of ``config`` moves at least once, which
``work.floor_bytes`` returns for a configuration whose ``system`` names the
file and ``mfu`` reads. Frozen here, out of the program's reach, as
``work.py`` is."""

"""The CPU size of every cell in these tests, whatever its configuration:
correctness runs at ``CHECK``, traced runs at ``TRACE``. Each is handed to
``measure`` as ``cfg_override``, so every generator takes ``scale`` and
every configuration ``n_parts``."""
CHECK = dict(scale=8, n_parts=4)
TRACE = dict(scale=7, n_parts=2)

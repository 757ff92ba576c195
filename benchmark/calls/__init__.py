"""The port's entries that a traffic mix can drive, one module each,
named by the mix's ``call`` (``benchmark/loop.py`` says what each
exports)."""

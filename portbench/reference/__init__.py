"""Plain references that decide a run's ``correct``: numpy only, nothing
of the program."""

"""Plain references that state each configuration's output; a
configuration file names its own under `reference`."""

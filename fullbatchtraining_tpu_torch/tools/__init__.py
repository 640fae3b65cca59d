"""Command-line tools of the port: the LMDB import and the upstream ``.pth`` interop."""

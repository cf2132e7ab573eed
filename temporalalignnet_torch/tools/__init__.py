"""Offline tools of the port: S3D feature extraction (``extract_features``)
and HTM-AA generation from a trained TAN (``generate_htm_aa``).  Each module
is imported on its own; none is imported here."""

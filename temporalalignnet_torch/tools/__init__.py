"""Tools of the port: S3D feature extraction (``extract_features``), HTM-AA
generation from a trained TAN (``generate_htm_aa``), the serving export of
the eval forward (``export_eval``) and the bare reference checkpoint
(``export_torch``).  Each module is imported on its own; none is imported
here."""

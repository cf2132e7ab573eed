"""Tools of the port: S3D feature extraction (``extract_features``), HTM-AA
generation from a trained TAN (``generate_htm_aa``), the serving export of
the eval forward (``export_eval``), the bare reference checkpoint
(``export_torch``), and the offline text pipeline: the caption filters
(``filters``), the punctuator and sentence cutter (``sentencify``), the
three-step HowTo100M caption pipeline (``process_htm``), the caption
.jsonl converter (``convert_captions``) and the ASR stages
(``whisper_asr``).  Each module is imported on its own; none is imported
here."""

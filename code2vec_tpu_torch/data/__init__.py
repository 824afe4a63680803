"""Host input for the port: predict-time tokenization (``reader``) and the
packed wire format (``packed``)."""

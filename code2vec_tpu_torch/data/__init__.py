"""Host input for the port: tokenization (``reader``; the native C++
tokenizer in ``native``), the packed wire format (``packed``), the token
cache of the train split (``cache``), and the offline tools that make a
dataset from source (``extract_driver``, ``preprocess``)."""

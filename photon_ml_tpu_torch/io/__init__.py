"""IO layer: Avro wire format, data reader, model and score persistence
(copies and ports of ``photon_ml_tpu/io``)."""

"""The photon-avro-schemas record schemas, as Python dicts.

Reference parity: photon-avro-schemas/src/main/avro/*.avsc — field-for-field
identical (names, order, union shapes, defaults), so files are byte-level
interoperable with the reference pipeline. Doc strings trimmed. Copy of
``photon_ml_tpu/io/schemas.py``.
"""

from photon_ml_tpu_torch.io.avro import AvroSchema

_NS = "com.linkedin.photon.avro.generated"

FEATURE = {
    "name": "FeatureAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

NAME_TERM_VALUE = {
    "name": "NameTermValueAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE = {
    "name": "TrainingExampleAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE}},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}

BAYESIAN_LINEAR_MODEL = {
    "name": "BayesianLinearModelAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE}},
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}

SCORING_RESULT = {
    "name": "ScoringResultAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

LATENT_FACTOR = {
    "name": "LatentFactorAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "effectId", "type": "string"},
        {"name": "latentFactor", "type": {"type": "array", "items": "double"}},
    ],
}

FEATURE_SUMMARIZATION_RESULT = {
    "name": "FeatureSummarizationResultAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}


def training_example_schema() -> AvroSchema:
    return AvroSchema(TRAINING_EXAMPLE)


def bayesian_linear_model_schema() -> AvroSchema:
    return AvroSchema(BAYESIAN_LINEAR_MODEL)


def latent_factor_schema() -> AvroSchema:
    return AvroSchema(LATENT_FACTOR)


def feature_summarization_schema() -> AvroSchema:
    return AvroSchema(FEATURE_SUMMARIZATION_RESULT)


def scoring_result_schema() -> AvroSchema:
    return AvroSchema(SCORING_RESULT)

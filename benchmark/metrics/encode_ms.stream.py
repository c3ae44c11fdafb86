"""Milliseconds a request of the encode_image, encode_audio and
emotion_latent spans together (models/ encoders)."""
from harness.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, ("encode_image", "encode_audio",
                             "emotion_latent"), lambda r: 1)

"""Live serving: one stream (``HowlClient``) or many through one batched
engine (``client.stream_server.MultiStreamServer``)."""

from howl_tpu_torch.client.howl_client import FileAudioSource, HowlClient, MicrophoneAudioSource

__all__ = ["FileAudioSource", "HowlClient", "MicrophoneAudioSource"]

"""Host-side data of the port: manifests, audio files, the native prefetcher,
token shards, crops and collators."""

"""Host-side training data of the port: token shards, crops, collators."""

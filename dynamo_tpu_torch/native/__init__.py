"""Native (C++) components of the port, loaded with ctypes (port of
dynamo_tpu/native): the bulk KV transfer agent
(csrc/transfer_agent/agent.cpp), built on demand with g++ into the
gitignored ``_build/`` directory."""

from dynamo_tpu_torch.native.build import load_library

__all__ = ["load_library"]

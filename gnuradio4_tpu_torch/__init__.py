"""gnuradio4_tpu_torch — the PyTorch + CUDA port of gnuradio4_tpu.

The same flowgraph model as the JAX package (blocks under the same registry
names and settings, the same rate algebra, ``Graph`` → ``compile_graph`` →
``Scheduler``, YAML flowgraphs, checkpoints), running on PyTorch tensors on
one device: the CUDA card unless the caller asks for the CPU (``device="cpu"``,
``--cpu``). Kernels the JAX package wrote in Pallas for the TPU are hand-written
CUDA C++ for Hopper here (``csrc/``, built at first use); every one has a plain
PyTorch version that runs on the CPU.

This package imports torch and NumPy and never JAX or PyYAML.
"""

from .core.block import (Block, BlockCtx, HostCtx, Port, PortRef, SinkBlock,
                         SourceBlock, UICategory)
from .core.compute_domain import ComputeDomain, DomainKind
from .core.compiler import CompiledGraph, compile_graph, default_device
from .core.errors import Error, GrError
from .core.graph import Edge, Graph
from .core.lifecycle import State
from .core.messages import Command, Message, MessageBus, Property
from .core.profiler import NullProfiler, Profiler
from .core.registry import (BlockRegistry, PluginLoader, global_registry,
                            global_scheduler_registry, register_block,
                            register_scheduler)
from .core.runtime import PipeSink, Runtime
from .core.scheduler import (BreadthFirstScheduler, DepthFirstScheduler,
                             Scheduler, SimpleScheduler)
from .core.settings import Setting, Settings, SettingsCtx
from .core.stream import StreamSpec
from .core.tags import Keys, Tag, TagPropagation
from .core.dataset import Axis, DataSet, SignalMeta
from .core.datasink import (DataSink, DataSinkQuery, DataSinkRegistry,
                            DataSetPoller, MultiplexedPoller, OverflowPolicy,
                            SnapshotPoller, StreamingPoller, TriggerPoller,
                            global_data_sink_registry)
from .core.merge import merge
from .core.trigger import (BasicTriggerNameCtxMatcher, MatchResult,
                           match_trigger)
from .core.yaml_io import load_grc, run_grc, save_grc
from .core.checkpoint import load_checkpoint, save_checkpoint
from .core import pmt

# importing the block library populates the global registry
from . import blocks  # noqa: E402,F401
from . import ops, parallel, utils  # noqa: E402,F401

__version__ = "0.1.0"

__all__ = [
    "Block", "BlockCtx", "HostCtx", "Port", "PortRef", "SinkBlock",
    "SourceBlock", "UICategory", "CompiledGraph", "compile_graph",
    "default_device", "Error",
    "GrError", "Edge", "Graph", "State", "Command", "Message", "MessageBus",
    "Property", "NullProfiler", "Profiler", "BlockRegistry", "global_registry",
    "global_scheduler_registry", "register_block", "register_scheduler",
    "BreadthFirstScheduler", "DepthFirstScheduler", "Scheduler",
    "SimpleScheduler", "Setting", "Settings", "SettingsCtx", "Keys", "Tag",
    "TagPropagation", "PluginLoader", "Axis", "DataSet", "SignalMeta",
    "DataSink", "DataSinkQuery", "DataSinkRegistry", "global_data_sink_registry",
    "DataSetPoller", "MultiplexedPoller", "OverflowPolicy", "SnapshotPoller",
    "StreamingPoller", "TriggerPoller", "BasicTriggerNameCtxMatcher",
    "MatchResult", "match_trigger", "load_grc", "run_grc", "save_grc",
    "load_checkpoint", "save_checkpoint", "pmt", "ComputeDomain", "DomainKind",
    "StreamSpec", "Runtime", "PipeSink", "merge",
]

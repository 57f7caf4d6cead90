from .chaos import ChaosEvent, ChaosHarness, ChaosRecovery, ChaosReport, \
    DegradedLink, LinkEvent, bitflip_checkpoint, seeded_link_script, \
    seeded_script
from .elastic import ElasticPlan, replan_on_failure, FailureEvent
from .straggler import StragglerMonitor
from .transport import Envelope, ItemLedger, TransportConfig, TransportStats

__all__ = ["ElasticPlan", "replan_on_failure", "FailureEvent",
           "StragglerMonitor", "ChaosEvent", "ChaosHarness",
           "ChaosRecovery", "ChaosReport", "seeded_script",
           "DegradedLink", "LinkEvent", "seeded_link_script",
           "bitflip_checkpoint", "Envelope", "ItemLedger",
           "TransportConfig", "TransportStats"]

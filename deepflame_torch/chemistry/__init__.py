from .mechanism import Mechanism, load_mechanism
from .thermo import ThermoData, make_thermo
from .kinetics import KineticsData, make_kinetics, production_rates
from .transport import TransportData, make_transport

__all__ = ["Mechanism", "load_mechanism", "ThermoData", "make_thermo",
           "KineticsData", "make_kinetics", "production_rates",
           "TransportData", "make_transport"]

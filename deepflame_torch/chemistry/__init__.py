from .mechanism import Mechanism, load_mechanism
from .thermo import ThermoData, make_thermo
from .kinetics import (KineticsData, heat_release_rate, make_kinetics,
                       mass_production_rates, production_rates)
from .transport import TransportData, make_transport

__all__ = ["Mechanism", "load_mechanism", "ThermoData", "make_thermo",
           "KineticsData", "make_kinetics", "production_rates",
           "mass_production_rates", "heat_release_rate",
           "TransportData", "make_transport"]

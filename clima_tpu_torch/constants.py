"""Physical constants (cgs-with-exceptions, matching the reference conventions).

Mirrors Nicholaswogan/clima ``src/clima_const.f90:1-26``. The reference keeps
pressure in dynes/cm^2 internally, hands bars to radiative transfer, and uses
mW/m^2 fluxes and nm wavelengths. We keep the identical convention so numerics
are transcription-free.
"""

Rgas = 8.31446261815324e7  # ideal gas constant (erg/(mol*K))
Rgas_si = 8.31446261815324  # ideal gas constant (J/(mol*K))
k_boltz = 1.380649e-16  # Boltzmann constant cgs (erg/K)
k_boltz_si = 1.380649e-23  # Boltzmann constant SI (J/K)
G_grav = 6.67430e-11  # gravitational constant (N m^2 / kg^2)
plank = 6.62607004e-34  # Planck constant (m^2 kg / s)
c_light = 299792458.0  # speed of light (m/s)
N_avo = 6.02214076e23  # Avogadro's number
sigma_si = 5.670374419e-8  # Stefan-Boltzmann (W/m^2/K^4)
pi = 3.14159265358979323846
von_karman_const = 0.41

# Clamps used by the radiative transfer (clima_radtran_types.f90:9-11)
max_w0 = 0.99999
max_gt = 0.999999
tau_min = 1.0e-20

# log10(sqrt(tiny(1.0_dp))) from clima_const.f90:21
import math as _math

log10tiny = _math.log10(_math.sqrt(2.2250738585072014e-308))

s_str_len = 20

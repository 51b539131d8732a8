// Native batched environment engine for the host data plane.
//
// The reference gets native env speed from C deps (the ALE emulator,
// mujoco-py) stepped one env per subprocess (subproc_vec_env.py:60-88).
// Here the batch itself is native: N classic-control envs stepped as one
// OpenMP-parallel C++ call behind a flat C ABI, so the host side of the
// io_callback bridge costs one function call per batched step instead of
// N python env.step()s + pipe round-trips.
//
// Env dynamics mirror gymnasium's classic_control physics (and therefore
// our pure-JAX envs, which are tested against them):
//   CartPole-v0/v1, Pendulum-v1, MountainCar-v0, MountainCarContinuous-v0,
//   Acrobot-v1.
//
// Semantics contract (matches GymAdapter / subproc_vec_env.py:8-12):
//   - step() auto-resets each done env; `obs` out is the post-reset obs and
//     `terminal_obs` out is the pre-reset terminal obs.
//   - TimeLimit truncation is folded into `done` (gym-0.x combined done).
//
// C ABI (ctypes-friendly; see baselines_tpu/native/__init__.py):
//   btenv_create(name, num_envs, seed, first_env) -> handle
//     (env i of the pool is env first_env + i of the whole batch and draws from
//     the generator seeded by (seed, first_env + i), so that a data-parallel
//     rank's pool steps the envs the one-process pool steps in those places)
//   btenv_reset(h, obs_out)
//   btenv_step(h, actions_f32, obs_out, rew_out, done_out, terminal_obs_out)
//   btenv_get_state / btenv_set_state  (testing: physics state round-trip)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double PI = 3.14159265358979323846;

// --- per-env RNG: splitmix64 -> uniform floats (independent streams) ------
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next_u64() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // uniform in [lo, hi)
  double uniform(double lo, double hi) {
    double u = (next_u64() >> 11) * (1.0 / 9007199254740992.0);
    return lo + u * (hi - lo);
  }
};

struct EnvSpec {
  int obs_dim;
  int act_dim;      // flattened continuous action dim (1 for discrete)
  int n_actions;    // >0 => discrete with n_actions
  int state_dim;    // physics state floats per env
  int max_steps;    // TimeLimit (0 = none)
};

// --- env kinds -------------------------------------------------------------
enum class Kind { CartPole, Pendulum, MountainCar, MountainCarCont, Acrobot };

struct Pool {
  Kind kind;
  EnvSpec spec;
  int n;
  std::vector<double> state;    // n * state_dim
  std::vector<int> elapsed;     // TimeLimit counters
  std::vector<Rng> rng;
};

// ---------------------------------------------------------------------------
// physics (gymnasium classic_control formulas)
// ---------------------------------------------------------------------------

void cartpole_reset(Pool& p, int i, float* obs) {
  double* s = &p.state[i * 4];
  for (int k = 0; k < 4; ++k) s[k] = p.rng[i].uniform(-0.05, 0.05);
  p.elapsed[i] = 0;
  for (int k = 0; k < 4; ++k) obs[k] = (float)s[k];
}

bool cartpole_step(Pool& p, int i, const float* act, float* obs, float* rew) {
  constexpr double GRAVITY = 9.8, MASSCART = 1.0, MASSPOLE = 0.1;
  constexpr double TOTAL_MASS = MASSCART + MASSPOLE, LENGTH = 0.5;
  constexpr double POLEMASS_LENGTH = MASSPOLE * LENGTH, FORCE_MAG = 10.0;
  constexpr double TAU = 0.02;
  const double THETA_THRESH = 12.0 * 2.0 * PI / 360.0, X_THRESH = 2.4;
  double* s = &p.state[i * 4];
  double x = s[0], x_dot = s[1], theta = s[2], theta_dot = s[3];
  double force = (act[0] > 0.5) ? FORCE_MAG : -FORCE_MAG;
  double costheta = std::cos(theta), sintheta = std::sin(theta);
  double temp =
      (force + POLEMASS_LENGTH * theta_dot * theta_dot * sintheta) / TOTAL_MASS;
  double thetaacc = (GRAVITY * sintheta - costheta * temp) /
                    (LENGTH * (4.0 / 3.0 - MASSPOLE * costheta * costheta / TOTAL_MASS));
  double xacc = temp - POLEMASS_LENGTH * thetaacc * costheta / TOTAL_MASS;
  x += TAU * x_dot;
  x_dot += TAU * xacc;
  theta += TAU * theta_dot;
  theta_dot += TAU * thetaacc;
  s[0] = x; s[1] = x_dot; s[2] = theta; s[3] = theta_dot;
  obs[0] = (float)x; obs[1] = (float)x_dot; obs[2] = (float)theta; obs[3] = (float)theta_dot;
  *rew = 1.0f;
  return x < -X_THRESH || x > X_THRESH || theta < -THETA_THRESH || theta > THETA_THRESH;
}

double angle_normalize(double x) {
  double y = std::fmod(x + PI, 2.0 * PI);
  if (y < 0) y += 2.0 * PI;
  return y - PI;
}

void pendulum_reset(Pool& p, int i, float* obs) {
  double* s = &p.state[i * 2];
  s[0] = p.rng[i].uniform(-PI, PI);
  s[1] = p.rng[i].uniform(-1.0, 1.0);
  p.elapsed[i] = 0;
  obs[0] = (float)std::cos(s[0]); obs[1] = (float)std::sin(s[0]); obs[2] = (float)s[1];
}

bool pendulum_step(Pool& p, int i, const float* act, float* obs, float* rew) {
  constexpr double MAX_SPEED = 8.0, MAX_TORQUE = 2.0, DT = 0.05, G = 10.0, M = 1.0, L = 1.0;
  double* s = &p.state[i * 2];
  double th = s[0], thdot = s[1];
  double u = act[0];
  if (u > MAX_TORQUE) u = MAX_TORQUE;
  if (u < -MAX_TORQUE) u = -MAX_TORQUE;
  double an = angle_normalize(th);
  double cost = an * an + 0.1 * thdot * thdot + 0.001 * u * u;
  double newthdot = thdot + (3.0 * G / (2.0 * L) * std::sin(th) + 3.0 / (M * L * L) * u) * DT;
  if (newthdot > MAX_SPEED) newthdot = MAX_SPEED;
  if (newthdot < -MAX_SPEED) newthdot = -MAX_SPEED;
  double newth = th + newthdot * DT;
  s[0] = newth; s[1] = newthdot;
  obs[0] = (float)std::cos(newth); obs[1] = (float)std::sin(newth); obs[2] = (float)newthdot;
  *rew = (float)(-cost);
  return false;
}

void mcar_reset(Pool& p, int i, float* obs) {
  double* s = &p.state[i * 2];
  s[0] = p.rng[i].uniform(-0.6, -0.4);
  s[1] = 0.0;
  p.elapsed[i] = 0;
  obs[0] = (float)s[0]; obs[1] = (float)s[1];
}

bool mcar_step(Pool& p, int i, const float* act, float* obs, float* rew, bool continuous) {
  constexpr double MIN_POS = -1.2, MAX_POS = 0.6, MAX_SPEED = 0.07;
  double* s = &p.state[i * 2];
  double position = s[0], velocity = s[1];
  bool done;
  if (continuous) {
    constexpr double POWER = 0.0015, GOAL = 0.45;
    double force = act[0];
    if (force > 1.0) force = 1.0;
    if (force < -1.0) force = -1.0;
    velocity += force * POWER - 0.0025 * std::cos(3.0 * position);
    if (velocity > MAX_SPEED) velocity = MAX_SPEED;
    if (velocity < -MAX_SPEED) velocity = -MAX_SPEED;
    position += velocity;
    if (position > MAX_POS) position = MAX_POS;
    if (position < MIN_POS) position = MIN_POS;
    if (position <= MIN_POS && velocity < 0) velocity = 0.0;
    done = position >= GOAL && velocity >= 0.0;  // gymnasium: forward at goal
    *rew = (float)((done ? 100.0 : 0.0) - 0.1 * force * force);
  } else {
    constexpr double FORCE = 0.001, GRAVITY = 0.0025, GOAL = 0.5;
    int a = (int)std::lround(act[0]);
    velocity += (a - 1) * FORCE + std::cos(3.0 * position) * (-GRAVITY);
    if (velocity > MAX_SPEED) velocity = MAX_SPEED;
    if (velocity < -MAX_SPEED) velocity = -MAX_SPEED;
    position += velocity;
    if (position > MAX_POS) position = MAX_POS;
    if (position < MIN_POS) position = MIN_POS;
    if (position <= MIN_POS && velocity < 0) velocity = 0.0;
    done = position >= GOAL && velocity >= 0.0;
    *rew = -1.0f;
  }
  s[0] = position; s[1] = velocity;
  obs[0] = (float)position; obs[1] = (float)velocity;
  return done;
}

// Acrobot: "book" dynamics + RK4 over dt=0.2 (gymnasium AcrobotEnv).
void acrobot_dsdt(const double* s, double a, double* out) {
  constexpr double m1 = 1.0, m2 = 1.0, l1 = 1.0, lc1 = 0.5, lc2 = 0.5;
  constexpr double i1 = 1.0, i2 = 1.0, g = 9.8;
  double theta1 = s[0], theta2 = s[1], dtheta1 = s[2], dtheta2 = s[3];
  double d1 = m1 * lc1 * lc1 +
              m2 * (l1 * l1 + lc2 * lc2 + 2.0 * l1 * lc2 * std::cos(theta2)) + i1 + i2;
  double d2 = m2 * (lc2 * lc2 + l1 * lc2 * std::cos(theta2)) + i2;
  double phi2 = m2 * lc2 * g * std::cos(theta1 + theta2 - PI / 2.0);
  double phi1 = -m2 * l1 * lc2 * dtheta2 * dtheta2 * std::sin(theta2) -
                2.0 * m2 * l1 * lc2 * dtheta2 * dtheta1 * std::sin(theta2) +
                (m1 * lc1 + m2 * l1) * g * std::cos(theta1 - PI / 2.0) + phi2;
  double ddtheta2 =
      (a + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1 * dtheta1 * std::sin(theta2) - phi2) /
      (m2 * lc2 * lc2 + i2 - d2 * d2 / d1);
  double ddtheta1 = -(d2 * ddtheta2 + phi1) / d1;
  out[0] = dtheta1; out[1] = dtheta2; out[2] = ddtheta1; out[3] = ddtheta2;
}

double wrap(double x, double lo, double hi) {
  double diff = hi - lo;
  double y = std::fmod(x - lo, diff);
  if (y < 0) y += diff;
  return y + lo;
}

void acrobot_reset(Pool& p, int i, float* obs) {
  double* s = &p.state[i * 4];
  for (int k = 0; k < 4; ++k) s[k] = p.rng[i].uniform(-0.1, 0.1);
  p.elapsed[i] = 0;
  obs[0] = (float)std::cos(s[0]); obs[1] = (float)std::sin(s[0]);
  obs[2] = (float)std::cos(s[1]); obs[3] = (float)std::sin(s[1]);
  obs[4] = (float)s[2]; obs[5] = (float)s[3];
}

bool acrobot_step(Pool& p, int i, const float* act, float* obs, float* rew) {
  constexpr double DT = 0.2;
  const double MAX_VEL_1 = 4.0 * PI, MAX_VEL_2 = 9.0 * PI;
  double* s = &p.state[i * 4];
  double torque = (double)((int)std::lround(act[0]) - 1);  // {-1, 0, +1}
  // RK4 on [theta1, theta2, dtheta1, dtheta2] with constant torque
  double k1[4], k2[4], k3[4], k4[4], tmp[4];
  acrobot_dsdt(s, torque, k1);
  for (int k = 0; k < 4; ++k) tmp[k] = s[k] + DT / 2.0 * k1[k];
  acrobot_dsdt(tmp, torque, k2);
  for (int k = 0; k < 4; ++k) tmp[k] = s[k] + DT / 2.0 * k2[k];
  acrobot_dsdt(tmp, torque, k3);
  for (int k = 0; k < 4; ++k) tmp[k] = s[k] + DT * k3[k];
  acrobot_dsdt(tmp, torque, k4);
  for (int k = 0; k < 4; ++k)
    s[k] += DT / 6.0 * (k1[k] + 2.0 * k2[k] + 2.0 * k3[k] + k4[k]);
  s[0] = wrap(s[0], -PI, PI);
  s[1] = wrap(s[1], -PI, PI);
  if (s[2] > MAX_VEL_1) s[2] = MAX_VEL_1;
  if (s[2] < -MAX_VEL_1) s[2] = -MAX_VEL_1;
  if (s[3] > MAX_VEL_2) s[3] = MAX_VEL_2;
  if (s[3] < -MAX_VEL_2) s[3] = -MAX_VEL_2;
  bool done = (-std::cos(s[0]) - std::cos(s[1] + s[0])) > 1.0;
  *rew = done ? 0.0f : -1.0f;
  obs[0] = (float)std::cos(s[0]); obs[1] = (float)std::sin(s[0]);
  obs[2] = (float)std::cos(s[1]); obs[3] = (float)std::sin(s[1]);
  obs[4] = (float)s[2]; obs[5] = (float)s[3];
  return done;
}

// --- dispatch ---------------------------------------------------------------

void env_reset_one(Pool& p, int i, float* obs) {
  switch (p.kind) {
    case Kind::CartPole: cartpole_reset(p, i, obs); break;
    case Kind::Pendulum: pendulum_reset(p, i, obs); break;
    case Kind::MountainCar:
    case Kind::MountainCarCont: mcar_reset(p, i, obs); break;
    case Kind::Acrobot: acrobot_reset(p, i, obs); break;
  }
}

bool env_step_one(Pool& p, int i, const float* act, float* obs, float* rew) {
  switch (p.kind) {
    case Kind::CartPole: return cartpole_step(p, i, act, obs, rew);
    case Kind::Pendulum: return pendulum_step(p, i, act, obs, rew);
    case Kind::MountainCar: return mcar_step(p, i, act, obs, rew, false);
    case Kind::MountainCarCont: return mcar_step(p, i, act, obs, rew, true);
    case Kind::Acrobot: return acrobot_step(p, i, act, obs, rew);
  }
  return false;
}

}  // namespace

extern "C" {

void* btenv_create(const char* name, int num_envs, uint64_t seed, uint64_t first_env) {
  std::string id(name);
  Pool* p = new Pool();
  p->n = num_envs;
  if (id == "CartPole-v0" || id == "CartPole-v1") {
    p->kind = Kind::CartPole;
    p->spec = {4, 1, 2, 4, id == "CartPole-v0" ? 200 : 500};
  } else if (id == "Pendulum-v1") {
    p->kind = Kind::Pendulum;
    p->spec = {3, 1, 0, 2, 200};
  } else if (id == "MountainCar-v0") {
    p->kind = Kind::MountainCar;
    p->spec = {2, 1, 3, 2, 200};
  } else if (id == "MountainCarContinuous-v0") {
    p->kind = Kind::MountainCarCont;
    p->spec = {2, 1, 0, 2, 999};
  } else if (id == "Acrobot-v1") {
    p->kind = Kind::Acrobot;
    p->spec = {6, 1, 3, 4, 500};
  } else {
    delete p;
    return nullptr;
  }
  p->state.assign((size_t)num_envs * p->spec.state_dim, 0.0);
  p->elapsed.assign(num_envs, 0);
  p->rng.reserve(num_envs);
  for (int i = 0; i < num_envs; ++i)
    p->rng.emplace_back(seed * 0x2545F4914F6CDD1DULL + first_env + (uint64_t)i + 1);
  return p;
}

void btenv_destroy(void* h) { delete (Pool*)h; }

int btenv_obs_dim(void* h) { return ((Pool*)h)->spec.obs_dim; }
int btenv_act_dim(void* h) { return ((Pool*)h)->spec.act_dim; }
int btenv_n_actions(void* h) { return ((Pool*)h)->spec.n_actions; }
int btenv_state_dim(void* h) { return ((Pool*)h)->spec.state_dim; }
int btenv_max_steps(void* h) { return ((Pool*)h)->spec.max_steps; }

void btenv_reset(void* h, float* obs) {
  Pool& p = *(Pool*)h;
  const int od = p.spec.obs_dim;
#pragma omp parallel for schedule(static) if (p.n >= 64)
  for (int i = 0; i < p.n; ++i) env_reset_one(p, i, obs + (size_t)i * od);
}

void btenv_step(void* h, const float* actions, float* obs, float* rew,
                uint8_t* done, float* terminal_obs) {
  Pool& p = *(Pool*)h;
  const int od = p.spec.obs_dim, ad = p.spec.act_dim;
#pragma omp parallel for schedule(static) if (p.n >= 64)
  for (int i = 0; i < p.n; ++i) {
    float* o = obs + (size_t)i * od;
    bool d = env_step_one(p, i, actions + (size_t)i * ad, o, rew + i);
    p.elapsed[i] += 1;
    if (p.spec.max_steps > 0 && p.elapsed[i] >= p.spec.max_steps) d = true;
    std::memcpy(terminal_obs + (size_t)i * od, o, sizeof(float) * od);
    if (d) env_reset_one(p, i, o);  // auto-reset: obs out = reset obs
    done[i] = d ? 1 : 0;
  }
}

void btenv_get_state(void* h, double* out) {
  Pool& p = *(Pool*)h;
  std::memcpy(out, p.state.data(), p.state.size() * sizeof(double));
}

void btenv_set_state(void* h, const double* in) {
  Pool& p = *(Pool*)h;
  std::memcpy(p.state.data(), in, p.state.size() * sizeof(double));
  std::fill(p.elapsed.begin(), p.elapsed.end(), 0);
}

}  // extern "C"
